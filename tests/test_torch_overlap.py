"""Overlapped outer rounds of the port (``overlap_comm`` "delayed" and
"eager") under both placements, on the CPU.

The patterns of ``tests/test_diloco.py`` (the overlap tests): the identity
outer step reproduces plain training, two overlapped workers end with the
same master, inner steps go on while a slow all-reduce flies. Beside
them: device placement equals host placement bit for bit with two
workers, a snapshot taken from another thread during a round is the
pre-round or the post-round master and never a mix, and ``train()``
lands a round in flight before each checkpoint and at the end, and drops
it when the run fails. (The port's overlap against the JAX package's:
``test_torch_outer_device.py::test_placement_parity``.)
"""
import hashlib
import sys
import threading
import time

import numpy as np
import pytest
import torch

from opendiloco_torch.config import DilocoConfig
from opendiloco_torch.diloco import DiLoCoOptimizer, LoopbackWorld
from opendiloco_torch.models.llama import flatten_params
from opendiloco_torch.train import train
from test_outer_placement import batches
from test_torch_outer_device import assert_same_state, init_params, port_trainer, run_pair, run_port  # noqa: F401
from test_torch_train import _train_config

torch.set_num_threads(2)

PLACEMENTS = ["host", "device"]
MODES = ["delayed", "eager"]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("placement", PLACEMENTS)
def test_overlap_identity_equals_plain_training(tiny_cfg, init_params, placement, mode):
    """One worker, outer_lr 1, momentum 0: the outer update is the boundary
    rewrite b -> b, so both modes reproduce plain training. Tolerance rtol
    1e-5, atol 1e-6 (the reference's): the rewrite lands as m - (m - b),
    which rounds once, and the inner AdamW carries that ulp on."""
    trainer = port_trainer(tiny_cfg)
    state = trainer.init_state(params=init_params)
    ref_losses = []
    for ids, labels in batches(0, tiny_cfg.vocab_size, 8):
        state, m = trainer.train_step(state, trainer.shard_batch(ids, labels, accum=1))
        ref_losses.append(float(m["loss"]))
    ref = [p.detach().numpy().copy() for p in flatten_params(state["params"])]
    losses, state, opt = run_port(tiny_cfg, init_params, placement, n_steps=8, local_steps=4, overlap=mode,
                                  outer_lr=1.0, outer_momentum=0.0, pinned=False)
    assert opt.epoch == 2
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5, atol=1e-6)
    for a, b in zip(flatten_params(state["params"]), ref):
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("placement", PLACEMENTS)
def test_overlap_two_workers_masters_converge(tiny_cfg, init_params, placement, mode):
    """Two overlapped workers end, after the final flush, with the same
    master bit for bit, whichever step each landed its rounds at."""
    (_, s0), (_, s1) = run_pair(tiny_cfg, init_params, placement, local_steps=4, n_steps=8, overlap=mode,
                                pinned=False)
    assert s0["epoch"] == s1["epoch"] == 2
    for a, b in zip(s0["master"], s1["master"]):
        assert np.array_equal(a, b) and np.all(np.isfinite(a))


@pytest.mark.parametrize("mode", MODES)
def test_overlap_device_equals_host_two_workers(tiny_cfg, init_params, mode):
    """Two workers, the landing schedule pinned: device placement's losses,
    masters and momentum are host placement's, bit for bit."""
    host = run_pair(tiny_cfg, init_params, "host", local_steps=2, n_steps=6, overlap=mode)
    dev = run_pair(tiny_cfg, init_params, "device", local_steps=2, n_steps=6, overlap=mode)
    for (lh, sh), (ld, sd) in zip(host, dev):
        assert lh == ld
        assert_same_state(sh, sd)


@pytest.mark.parametrize("placement", PLACEMENTS)
def test_overlap_inner_steps_continue_during_comm(tiny_cfg, init_params, placement):
    """With a slow all-reduce the boundary step returns at once and the
    next inner step does not wait for the round."""
    (backend,) = LoopbackWorld(1).make_backends()
    orig = backend.all_reduce

    def slow_all_reduce(arrays, **kw):
        time.sleep(1.0)
        return orig(arrays, **kw)

    backend.all_reduce = slow_all_reduce
    trainer = port_trainer(tiny_cfg)
    state = trainer.init_state(params=init_params)
    cfg = DilocoConfig(local_steps=2, backend="loopback", overlap_comm="delayed", outer_placement=placement)
    opt = DiLoCoOptimizer(trainer, backend, cfg, state, batch_size=8)
    data = list(batches(2, tiny_cfg.vocab_size, 4))
    for ids, labels in data[:2]:
        state, m = opt.step(state, trainer.shard_batch(ids, labels, accum=1))
    assert m.get("outer_overlapped") == 1
    assert opt._pending is not None  # the round still flies
    t0 = time.monotonic()
    state, _ = opt.step(state, trainer.shard_batch(*data[2], accum=1))
    assert time.monotonic() - t0 < 0.9  # did not wait for the slow round
    state = opt.flush(state)
    assert opt._pending is None and opt.epoch == 1


def _hash(masters) -> str:
    h = hashlib.sha256()
    for m in masters:
        h.update(np.ascontiguousarray(m, np.float32).tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("mode", ["none", *MODES])
@pytest.mark.parametrize("placement", PLACEMENTS)
def test_snapshot_during_round_is_pre_or_post_round(tiny_cfg, init_params, placement, mode):
    """A thread takes serving snapshots (``master_snapshot``) and peer
    fetches (``_state_for_peers``) without pause while the worker trains
    through three rounds. Every snapshot at epoch k is the master M_k
    that round k - 1 left (M_0 the init): never the eager estimate, never
    a master half stepped, never a new epoch with an old master."""
    trainer = port_trainer(tiny_cfg)
    state = trainer.init_state(params=init_params)
    (backend,) = LoopbackWorld(1).make_backends()
    opt = DiLoCoOptimizer(trainer, backend, DilocoConfig(local_steps=3, backend="loopback", overlap_comm=mode,
                                                         outer_placement=placement), state, batch_size=8)
    want = {0: _hash(opt.state_dict()["master"])}
    seen, stop, errors = [], threading.Event(), []

    def snapshot():
        try:
            while not stop.is_set():
                epoch, masters = opt.master_snapshot()
                seen.append((epoch, _hash(masters)))
                peer = opt._state_for_peers()
                seen.append((peer["epoch"], _hash(peer["master"])))
        except Exception as e:  # pragma: no cover
            errors.append(e)

    t = threading.Thread(target=snapshot)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # switch threads often: a torn read must show
    t.start()
    try:
        for ids, labels in batches(0, tiny_cfg.vocab_size, 10):
            state, _ = opt.step(state, trainer.shard_batch(ids, labels, accum=1))
            if opt._pending is not None:
                # let the round resolve, and the thread look, before it lands
                while not opt._pending["future"].done():
                    time.sleep(0.001)
                time.sleep(0.01)
            else:
                want.setdefault(opt.epoch, _hash(opt.state_dict()["master"]))
        state = opt.flush(state)
        want.setdefault(opt.epoch, _hash(opt.state_dict()["master"]))
    finally:
        stop.set()
        t.join(timeout=60)
        sys.setswitchinterval(switch)
    assert not t.is_alive() and not errors, errors
    assert sorted(want) == [0, 1, 2, 3]
    assert len(seen) > 10
    bad = [(e, h[:12]) for e, h in seen if want.get(e) != h]
    assert not bad, (bad[:5], {k: v[:12] for k, v in want.items()})


class _Spy:
    """Records each flush and drop_pending of the optimizer train() builds,
    and whether a round was in flight after it."""

    def __init__(self, monkeypatch):
        self.calls = []
        flush, drop = DiLoCoOptimizer.flush, DiLoCoOptimizer.drop_pending

        def spy_flush(opt, state):
            out = flush(opt, state)
            self.calls.append(("flush", opt.epoch, opt._pending is None))
            return out

        def spy_drop(opt):
            before = opt._pending is not None
            drop(opt)
            self.calls.append(("drop", before, opt._pending is None))

        monkeypatch.setattr(DiLoCoOptimizer, "flush", spy_flush)
        monkeypatch.setattr(DiLoCoOptimizer, "drop_pending", spy_drop)


@pytest.mark.parametrize("placement", PLACEMENTS)
def test_train_flushes_rounds_and_drops_on_failure(tmp_path, monkeypatch, placement):
    """train() with eager rounds: each checkpoint (steps 4 and 8, where a
    round was just launched) and the end of the run flush it; the finally
    block drops rounds; a run that fails right after a boundary drops the
    round in flight."""
    spy = _Spy(monkeypatch)
    diloco = dict(local_steps=4, backend="loopback", world_rank=0, overlap_comm="eager", outer_placement=placement)
    summary = train(_train_config(tmp_path, 0, total_steps=8, diloco=diloco, ckpt=dict(path=str(tmp_path / "c"),
                                                                                         interval=4)),
                    LoopbackWorld(1).make_backends()[0], device="cpu")
    assert summary["step"] == 8 and np.isfinite(summary["loss"])
    # the first drop is the onboarding's (load_state_from_peers supersedes
    # rounds in flight)
    onboarding = ("drop", False, True)
    assert spy.calls == [onboarding, ("flush", 1, True), ("flush", 2, True), ("flush", 2, True), ("drop", False, True)]

    from opendiloco_torch.data import dataloader

    spy.calls.clear()
    real_iter = dataloader.FakeTokenizedDataset.__iter__

    def failing_iter(self):
        for i, row in enumerate(real_iter(self)):
            if i == 8 * 4:  # the fifth batch of 8 rows: the step after the boundary at 4
                raise RuntimeError("injected loader failure")
            yield row

    monkeypatch.setattr(dataloader.FakeTokenizedDataset, "__iter__", failing_iter)
    with pytest.raises(RuntimeError, match="injected loader failure"):
        train(_train_config(tmp_path, 1, total_steps=8, diloco=diloco), LoopbackWorld(1).make_backends()[0],
              device="cpu")
    assert spy.calls == [onboarding, ("drop", True, True)]
