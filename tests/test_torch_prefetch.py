"""The port's input prefetcher (``opendiloco_torch/data/prefetch.py``)
against the JAX package's, on the CPU.

The counterparts of ``tests/test_data.py``'s prefetcher tests (exact
resume state, error propagation, the exhaustion latch), the same host
batches and ``state_dict()`` sequence as the JAX ``DevicePrefetcher``
over the same fake stream, and ``train()`` through it: depth 0 and depth
2 give the same rows and the same checkpoint bytes, and a checkpoint
taken at depth 2 resumes to the uninterrupted run's rows. On the CPU every
op of a step repeats bit for bit, so these are equalities.
"""
import os
import pickle
import threading
import time

import numpy as np
import pytest
import torch

from opendiloco_tpu.data.dataloader import DataLoader as JDataLoader
from opendiloco_tpu.data.dataloader import FakeTokenizedDataset as JFakeTokenizedDataset
from opendiloco_tpu.data.prefetch import DevicePrefetcher as JDevicePrefetcher
from opendiloco_torch.config import Config
from opendiloco_torch.data.dataloader import DataLoader, FakeTokenizedDataset
from opendiloco_torch.data.prefetch import DevicePrefetcher
from opendiloco_torch.diloco import LoopbackWorld
from opendiloco_torch.train import train

torch.set_num_threads(2)

ROW_KEYS = ("Loss", "lr", "grad_norm")


def test_exact_resume_state():
    """state_dict() is the state of the last batch consumed, not of the
    read-ahead position: resuming from it replays exactly the batches the
    consumer never saw."""
    ds = FakeTokenizedDataset(8, 50, seed=3)
    loader = DataLoader(ds, batch_size=4, prefetch=8)
    pf = DevicePrefetcher(iter(loader), lambda hb: torch.from_numpy(hb["input_ids"] * 2), depth=3,
                          state_fn=loader.state_dict, device="cpu")
    for _ in range(3):
        host, dev = next(pf)
        np.testing.assert_array_equal(dev.numpy(), host["input_ids"] * 2)
    time.sleep(0.3)  # let the worker read well ahead
    sd = pf.state_dict()
    assert sd == {"dataset": {"samples_seen": 12, "seed": 3}}
    tail = [next(pf)[0] for _ in range(2)]
    pf.stop()
    loader.stop()

    loader2 = DataLoader(FakeTokenizedDataset(8, 50, seed=999), batch_size=4, prefetch=8)
    loader2.load_state_dict(sd)
    it2 = iter(loader2)
    resumed = [next(it2) for _ in range(2)]
    loader2.stop()
    for a, b in zip(tail, resumed):
        np.testing.assert_array_equal(a["input_ids"], b["input_ids"])


def test_errors_propagate_and_exhaustion_latches():
    def boom_iter():
        yield {"input_ids": np.zeros((2, 4), np.int32)}
        raise ValueError("boom")

    pf = DevicePrefetcher(boom_iter(), lambda hb: hb["input_ids"], depth=2, device="cpu")
    next(pf)
    with pytest.raises(ValueError, match="boom"):
        next(pf)
    # an exhausted iterator ends cleanly, and stays ended
    pf2 = DevicePrefetcher(iter([{"x": 1}]), lambda hb: hb, depth=2, device="cpu")
    assert next(pf2)[0] == {"x": 1}
    for _ in range(2):
        with pytest.raises(StopIteration):
            next(pf2)
    pf2.stop()
    with pytest.raises(ValueError, match="depth"):
        DevicePrefetcher(iter([]), lambda hb: hb, depth=0, device="cpu")


def test_stop_releases_a_blocked_producer():
    """A producer blocked on a full queue sees stop() and ends."""
    pf = DevicePrefetcher(iter(range(100)), lambda x: x, depth=1, device="cpu")
    time.sleep(0.1)
    t0 = time.perf_counter()
    pf.stop()
    assert not pf._thread.is_alive() and time.perf_counter() - t0 < 2.0
    with pytest.raises(StopIteration):
        next(pf)


@pytest.mark.parametrize("depth", [1, 3])
def test_same_batches_and_states_as_the_jax_prefetcher(depth):
    jl = JDataLoader(JFakeTokenizedDataset(16, 100, seed=5), batch_size=4, prefetch=2)
    tl = DataLoader(FakeTokenizedDataset(16, 100, seed=5), batch_size=4, prefetch=2)
    jpf = JDevicePrefetcher(iter(jl), lambda hb: hb["labels"], depth=depth, state_fn=jl.state_dict)
    tpf = DevicePrefetcher(iter(tl), lambda hb: torch.from_numpy(hb["labels"]), depth=depth,
                           state_fn=tl.state_dict, device="cpu")
    # the JAX loader's state also counts data epochs, which the port's
    # infinite stream has not (data/dataloader.py): the dataset part is held
    try:
        assert tpf.state_dict()["dataset"] == jpf.state_dict()["dataset"]
        for _ in range(6):
            (jh, jd), (th, td) = next(jpf), next(tpf)
            for k in ("input_ids", "labels"):
                np.testing.assert_array_equal(th[k], jh[k])
            np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
            assert tpf.state_dict()["dataset"] == jpf.state_dict()["dataset"]
    finally:
        for x in (jpf, tpf, jl, tl):
            x.stop()


@pytest.mark.parametrize("field,flag,value", [("prefetch_depth", "--prefetch-depth", "0"),
                                              ("num_workers", "--num-workers", "4")])
def test_config_fields_carry_the_jax_defaults_and_parse(field, flag, value):
    """A JAX config that sets either field constructs in the port, with the
    JAX package's default and from the command line as it parses there."""
    from opendiloco_tpu.config import Config as JConfig
    from opendiloco_tpu.config import parse_argv as jparse_argv
    from opendiloco_torch.config import parse_argv

    assert getattr(Config(), field) == getattr(JConfig(), field)
    assert parse_argv([flag, value]) == jparse_argv([flag, value])
    assert getattr(Config(**parse_argv([flag, value])), field) == getattr(JConfig(**jparse_argv([flag, value])),
                                                                          field) == int(value)


def _config(tmp_path, name, **kw):
    base = dict(path_model="2m", fake_data=True, fake_data_mode="ramp", seq_length=64,
                per_device_train_batch_size=4, total_batch_size=8, warmup_steps=2, total_steps=8, lr=3e-3,
                metric_logger_type="dummy", project=str(tmp_path / f"{name}.pkl"), precision="fp32",
                ckpt=dict(path=str(tmp_path / f"ckpt-{name}"), interval=4),
                diloco=dict(local_steps=4, backend="loopback", timeout_waiting_for_peers=30.0))
    base.update(kw)
    return Config(**base)


def _rows(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _files(folder) -> dict:
    out = {}
    for root, _, names in os.walk(folder):
        for n in names:
            with open(os.path.join(root, n), "rb") as f:
                out[os.path.relpath(os.path.join(root, n), folder)] = f.read()
    return out


def test_train_depth_0_and_2_give_the_same_run(tmp_path):
    """One worker, 8 steps, two outer rounds, checkpoints at 4 and 8: the
    rows, and every byte of the checkpoints (params, AdamW moments, the
    master and momentum, the loader state), equal without the prefetcher
    and through it."""
    for depth in (0, 2):
        summary = train(_config(tmp_path, f"d{depth}", prefetch_depth=depth),
                        LoopbackWorld(1).make_backends()[0], device="cpu")
        assert summary["step"] == 8
    r0, r2 = _rows(tmp_path / "d0.pkl"), _rows(tmp_path / "d2.pkl")
    assert [r["step"] for r in r2] == list(range(1, 9))
    for a, b in zip(r0, r2):
        assert all(a[k] == b[k] for k in ROW_KEYS), (a, b)
        assert "data_wait_s" in a and "data_wait_s" in b
    f0, f2 = _files(tmp_path / "ckpt-d0"), _files(tmp_path / "ckpt-d2")
    assert sorted(f0) == sorted(f2) and f0
    for name in f0:
        assert f0[name] == f2[name], name


def test_checkpoint_at_depth_2_resumes_exactly(tmp_path):
    """Two loopback workers at depth 2 (the default) with a checkpoint at
    step 4, then two fresh workers resuming from it: steps 5-8 equal the
    uninterrupted run's rows bit for bit, in both workers."""

    def run_pair(name, **kw):
        backends = LoopbackWorld(2).make_backends()
        errors = []

        def one(rank):
            try:
                cfg = _config(tmp_path, f"{name}-{rank}", **kw)
                cfg.diloco.world_rank = rank
                cfg.ckpt.path = str(tmp_path / "ckpt-pair")
                train(cfg, backends[rank], device="cpu")
            except Exception as e:  # pragma: no cover
                errors.append(e)

        threads = [threading.Thread(target=one, args=(r,)) for r in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not errors, errors

    run_pair("full")
    run_pair("resumed", ckpt=dict(interval=None, resume=str(tmp_path / "ckpt-pair" / "model_step_4")))
    for rank in range(2):
        full = {r["step"]: r for r in _rows(tmp_path / f"full-{rank}.pkl")}
        resumed = _rows(tmp_path / f"resumed-{rank}.pkl")
        assert [r["step"] for r in resumed] == [5, 6, 7, 8]
        for r in resumed:
            assert all(r[k] == full[r["step"]][k] for k in ROW_KEYS), (rank, r["step"])
