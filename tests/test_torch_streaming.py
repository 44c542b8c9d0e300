"""Streaming fragment sync of the port (``streaming_fragments`` > 1, with
and without overlap) under both placements, on the CPU.

The patterns of ``tests/test_streaming.py``:
1. the launch schedule and the fragment partition are pure functions of
   shared config (and equal the JAX package's), so every peer opens round
   ``frag{k}-epoch-{e}`` with the same shapes;
2. with ``local_steps=1`` over a one-worker loopback the average is the
   local pseudo-gradient, so the eager (and delayed) fragment rounds
   reproduce blocking full sync; tolerance rtol 1e-5, atol 1e-6 (the
   reference's): the rewrite lands as b + (true - est) + (est - b) in two
   deltas where blocking copies the master, an ulp a round that the inner
   AdamW carries on;
3. ``streaming_fragments=0`` leaves the blocking path alone.
Beside them: device placement equals host placement bit for bit, with
the landing schedule pinned (every round landed right after its step).
"""
import threading

import numpy as np
import pytest
import torch

from opendiloco_tpu.diloco.planner import fragment_partition as jfragment_partition
from opendiloco_tpu.diloco.streaming import launch_schedule as jlaunch_schedule
from opendiloco_torch.config import DilocoConfig
from opendiloco_torch.diloco import DiLoCoOptimizer, LoopbackWorld
from opendiloco_torch.diloco.planner import fragment_partition
from opendiloco_torch.diloco.streaming import launch_schedule
from test_torch_outer_device import assert_same_state, init_params, port_trainer, run_pair, run_port  # noqa: F401

torch.set_num_threads(2)

_RT, _AT = 1e-5, 1e-6


def run(tiny_cfg, params, placement, n_steps=6, local_steps=1, **kw):
    return run_port(tiny_cfg, params, placement, n_steps=n_steps, local_steps=local_steps, **kw)


# ---------------------------------------------------------------------------
# the schedule and the partition
# ---------------------------------------------------------------------------


def test_launch_schedule_matches_formula():
    assert launch_schedule(8, 4, 1.0) == [1, 3, 5, 7]
    assert launch_schedule(8, 4, 0.5) == [1, 2, 3, 4]
    assert launch_schedule(1, 3, 1.0) == [1, 1, 1]
    assert launch_schedule(2, 5, 1.0) == [1, 1, 1, 2, 2]


def test_launch_schedule_pure_bounded_and_the_jax_packages():
    for h in (1, 3, 8, 32):
        for n in (2, 3, 7):
            for stagger in (0.25, 0.5, 1.0):
                s = launch_schedule(h, n, stagger)
                assert s == launch_schedule(h, n, stagger) == jlaunch_schedule(h, n, stagger)
                assert len(s) == n and all(1 <= x <= h for x in s) and s == sorted(s)


def test_fragment_partition_is_the_jax_packages():
    rng = np.random.default_rng(0)
    cases = [([5, 5, 5, 5], 2), ([1, 100, 1, 1], 3), ([10] * 12, 5), (list(rng.integers(1, 1000, 12)), 3),
             ([1, 2, 3], 3)]
    for sizes, n in cases:
        assert fragment_partition(sizes, n) == jfragment_partition(sizes, n)
    with pytest.raises(ValueError):
        fragment_partition([1, 2], 3)


def test_schedule_and_partition_identical_across_peers(tiny_cfg, init_params):
    def build():
        trainer = port_trainer(tiny_cfg)
        state = trainer.init_state(params=init_params)
        (backend,) = LoopbackWorld(1).make_backends()
        cfg = DilocoConfig(local_steps=6, backend="loopback", streaming_fragments=3, overlap_comm="eager")
        return DiLoCoOptimizer(trainer, backend, cfg, state, batch_size=8)

    a, b = build(), build()
    assert a._stream.schedule == b._stream.schedule == launch_schedule(6, 3, 1.0)
    assert a._fragments == b._fragments
    assert sorted(i for f in a._fragments for i in f) == list(range(12))


@pytest.mark.parametrize("stagger", [1.0, 0.5, 0.25])
def test_stream_stagger_sets_launch_schedule(tiny_cfg, init_params, stagger):
    trainer = port_trainer(tiny_cfg)
    state = trainer.init_state(params=init_params)
    (backend,) = LoopbackWorld(1).make_backends()
    cfg = DilocoConfig(local_steps=8, backend="loopback", streaming_fragments=4, overlap_comm="delayed",
                       stream_stagger=stagger)
    opt = DiLoCoOptimizer(trainer, backend, cfg, state, batch_size=8)
    assert opt._stream.schedule == launch_schedule(8, 4, stagger) == jlaunch_schedule(8, 4, stagger)


def test_stream_arming(tiny_cfg, init_params):
    # fragments alone keep the blocking one-fragment-a-boundary path
    _, _, opt = run(tiny_cfg, init_params, "host", n_steps=2, frags=2)
    assert opt._stream is None and opt.trainer._post_dispatch_hooks == []
    # fragments x overlap arm the scheduler and its hook
    trainer = port_trainer(tiny_cfg)
    state = trainer.init_state(params=init_params)
    (backend,) = LoopbackWorld(1).make_backends()
    cfg = DilocoConfig(local_steps=1, backend="loopback", streaming_fragments=2, overlap_comm="eager")
    opt = DiLoCoOptimizer(trainer, backend, cfg, state, batch_size=8)
    assert len(trainer._post_dispatch_hooks) == 1 and opt._stream.schedule == [1, 1]
    ms = []
    from test_outer_placement import batches

    for ids, labels in batches(0, tiny_cfg.vocab_size, 3):
        state, m = opt.step(state, trainer.shard_batch(ids, labels, accum=1))
        ms.append(m)
        opt._stream.wait_inflight()
    state = opt.flush(state)
    assert opt._stream._inflight == {}
    # landings show in a later step's row
    assert any(m.get("outer_fragments_landed", 0) >= 1 for m in ms)
    assert all(m.get("outer_streaming_fragments") == 2 for m in ms)


# ---------------------------------------------------------------------------
# fragment rounds against blocking full sync, and across placements
# ---------------------------------------------------------------------------


def _close(opt_a, opt_b, la, lb):
    np.testing.assert_allclose(la, lb, rtol=_RT, atol=_AT)
    sa, sb = opt_a.state_dict(), opt_b.state_dict()
    assert sa["epoch"] == sb["epoch"]
    for a, b in zip(sa["master"], sb["master"]):
        np.testing.assert_allclose(a, b, rtol=_RT, atol=_AT)
    ba, bb = sa["outer_opt"]["bufs"], sb["outer_opt"]["bufs"]
    assert (ba is None) == (bb is None)
    for a, b in zip(ba or [], bb or []):
        np.testing.assert_allclose(a, b, rtol=_RT, atol=_AT)


@pytest.mark.parametrize("mode", ["eager", "delayed"])
@pytest.mark.parametrize("placement", ["host", "device"])
def test_streaming_matches_blocking(tiny_cfg, init_params, placement, mode):
    lb, _, ob = run(tiny_cfg, init_params, placement)
    ls, _, os_ = run(tiny_cfg, init_params, placement, frags=2, overlap=mode)
    _close(os_, ob, ls, lb)


@pytest.mark.parametrize("kw", [dict(overlap="eager"), dict(overlap="delayed"), dict(overlap="eager",
                                                                                      compression="fp16"),
                                dict()], ids=["eager", "delayed", "eager-fp16", "blocking"])
def test_streaming_device_equals_host(tiny_cfg, init_params, kw):
    """Three fragments, local_steps 3 (launches after steps 1, 2 and 3):
    losses, masters and momentum equal bit for bit across placements."""
    lh, _, oh = run(tiny_cfg, init_params, "host", n_steps=9, local_steps=3, frags=3, **kw)
    ld, _, od = run(tiny_cfg, init_params, "device", n_steps=9, local_steps=3, frags=3, **kw)
    assert lh == ld
    assert_same_state(oh.state_dict(), od.state_dict())


@pytest.mark.parametrize("placement", ["host", "device"])
def test_two_worker_masters_converge_identically(tiny_cfg, init_params, placement):
    """Two workers on different data, rounds landing whenever they land:
    each fragment round averages the same pair of pseudo-gradients, so
    the masters agree bit for bit."""
    (_, s0), (_, s1) = run_pair(tiny_cfg, init_params, placement, local_steps=3, n_steps=9, frags=2,
                                overlap="eager", pinned=False)
    assert s0["epoch"] == s1["epoch"] == 3
    for a, b in zip(s0["master"], s1["master"]):
        assert np.array_equal(a, b)


def test_streaming_off_path_bit_identity(tiny_cfg, init_params):
    l1, _, o1 = run(tiny_cfg, init_params, "host", n_steps=5, local_steps=2)
    l2, _, o2 = run(tiny_cfg, init_params, "host", n_steps=5, local_steps=2)
    assert o1._stream is None and o1.trainer._post_dispatch_hooks == []
    assert l1 == l2
    assert_same_state(o1.state_dict(), o2.state_dict())


def test_drop_all_forgets_rounds_in_flight(tiny_cfg, init_params):
    """State adoption drops every fragment round in flight; training goes
    on and the next rounds land."""
    trainer = port_trainer(tiny_cfg)
    state = trainer.init_state(params=init_params)
    (backend,) = LoopbackWorld(1).make_backends()
    gate = threading.Event()
    orig = backend.all_reduce

    def gated(arrays, **kw):
        gate.wait(10)
        return orig(arrays, **kw)

    backend.all_reduce = gated
    cfg = DilocoConfig(local_steps=2, backend="loopback", streaming_fragments=2, overlap_comm="eager",
                       outer_placement="device")
    opt = DiLoCoOptimizer(trainer, backend, cfg, state, batch_size=8)
    from test_outer_placement import batches

    data = list(batches(0, tiny_cfg.vocab_size, 4))
    for ids, labels in data[:2]:
        state, _ = opt.step(state, trainer.shard_batch(ids, labels, accum=1))
    assert len(opt._stream._inflight) == 2
    opt.drop_pending()
    assert opt._stream._inflight == {}
    gate.set()
    for ids, labels in data[2:]:
        state, _ = opt.step(state, trainer.shard_batch(ids, labels, accum=1))
    state = opt.flush(state)
    assert opt.epoch == 2 and opt._stream._inflight == {}
