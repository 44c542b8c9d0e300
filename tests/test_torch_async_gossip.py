"""The port's async (bounded-staleness) gossip rounds against the JAX
package's, on the CPU.

The patterns of ``tests/test_async_gossip.py`` on the port's
``diloco/gossip.py`` and loopback offer board: a distance-0 async match
mixes bit for bit as the lockstep pair round, in one exchange and over a
trajectory (exchanges, and the optimizer's training run); the window is
exact at its boundary; a partner beyond it, or none, is a self-round; a
transfer that fails after the match keeps the per-partner residual. Where
the JAX package's plane sees the same inputs, its result is held to the
port's bit for bit: both mix in numpy f32 in the same operand order.
"""
import threading

import jax
import numpy as np
import pytest
import torch

from opendiloco_tpu.diloco import gossip as jgossip
from opendiloco_tpu.diloco.loopback import LoopbackWorld as JLoopbackWorld
from opendiloco_torch.diloco import LoopbackWorld
from opendiloco_torch.diloco.gossip import GossipPlane
from opendiloco_torch.diloco.outer_optimizer import noloco_step, staleness_mix, staleness_weight

torch.set_num_threads(2)


def _leaves(seed, shapes=((6, 4), (5,))):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def _inputs():
    return [(_leaves(r), _leaves(10 + r), _leaves(20 + r)) for r in range(2)]


def _equal(a, b):
    return len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))


def run_pair(planes, epochs, inputs, frag_id=0, timeout=30.0):
    """Both workers' exchange() at their epochs, from two threads."""
    out, errors = [None, None], []

    def worker(rank):
        try:
            m, b, g = ([a.copy() for a in part] for part in inputs[rank])
            out[rank] = planes[rank].exchange(epoch=epochs[rank], frag_id=frag_id, idxs=list(range(len(m))),
                                              masters=m, bufs=b, pgs=g, timeout=timeout)
        except Exception as e:  # pragma: no cover - surfaced below
            errors.append((rank, e))

    ts = [threading.Thread(target=worker, args=(r,)) for r in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not errors, errors
    return out


def port_planes(compression, ef=False, n=2):
    world = LoopbackWorld(n)
    backends = world.make_backends()
    return world, backends, [GossipPlane(b, 2, compression=compression, error_feedback=ef) for b in backends]


def jax_planes(compression):
    return [jgossip.GossipPlane(b, 2, compression=compression) for b in JLoopbackWorld(2).make_backends()]


@pytest.mark.parametrize("compression", ["none", "blockwise4bit"])
def test_async_distance0_equals_lockstep_and_the_reference(monkeypatch, compression):
    inputs = _inputs()
    lockstep = run_pair(port_planes(compression)[2], (4, 4), inputs)
    monkeypatch.setenv("ODTP_ASYNC_STALENESS", "3")
    _, backends, planes = port_planes(compression)
    asynced = run_pair(planes, (4, 4), inputs)
    ref = run_pair(jax_planes(compression), (4, 4), inputs)
    for rank in range(2):
        assert lockstep[rank][4] == asynced[rank][4] == 2
        for k in range(3):
            assert _equal(lockstep[rank][k], asynced[rank][k])
            assert _equal(asynced[rank][k], ref[rank][k])
        h = backends[rank].last_round_health
        assert h["round"].startswith("gossip-af0-e4") and h["pair_lag"] == 0
        assert h["partner"] == backends[1 - rank].peer_id


def test_async_window_boundary_matches_with_the_staleness_weight(monkeypatch):
    """Distance equal to the window matches and mixes with 0.5 * 0.5**2;
    the pair's sum is kept; the JAX planes give the same bits."""
    monkeypatch.setenv("ODTP_ASYNC_STALENESS", "2")
    monkeypatch.setenv("ODTP_STATE_CODEC", "none")
    inputs = _inputs()
    _, backends, planes = port_planes("none")
    out = run_pair(planes, (3, 5), inputs)
    ref = run_pair(jax_planes("none"), (3, 5), inputs)
    w = staleness_weight(2)
    assert w == 0.125
    for rank, (mix_m, mix_b, avg_g, partner, n) in enumerate(out):
        assert n == 2 and partner == backends[1 - rank].peer_id
        assert backends[rank].last_round_health["pair_lag"] == 2
        mine, theirs = inputs[rank], inputs[1 - rank]
        want = [staleness_mix(mine[k], theirs[k], w) for k in range(3)]
        assert _equal(mix_m, want[0]) and _equal(mix_b, want[1]) and _equal(avg_g, want[2])
        for k in range(3):
            assert _equal(out[rank][k], ref[rank][k])
    for i in range(2):
        np.testing.assert_allclose(out[0][0][i] + out[1][0][i], inputs[0][0][i] + inputs[1][0][i], rtol=1e-5,
                                   atol=1e-6)


def test_async_beyond_the_window_self_rounds(monkeypatch):
    monkeypatch.setenv("ODTP_ASYNC_STALENESS", "2")
    monkeypatch.setenv("ODTP_ASYNC_PATIENCE_S", "0.3")
    inputs = _inputs()
    _, backends, planes = port_planes("blockwise4bit")
    out = run_pair(planes, (0, 3), inputs)
    for rank, (mix_m, mix_b, avg_g, partner, n) in enumerate(out):
        assert n == 1 and partner == backends[rank].peer_id
        m, b, g = inputs[rank]
        assert _equal(mix_m + mix_b + avg_g, m + b + g)  # no codec on a self-round
        assert "pair_lag" not in backends[rank].last_round_health


def test_async_hold_policy_drops_an_unmatched_round(monkeypatch):
    monkeypatch.setenv("ODTP_ASYNC_STALENESS", "1")
    monkeypatch.setenv("ODTP_ASYNC_PATIENCE_S", "0.2")
    monkeypatch.setenv("ODTP_GOSSIP_SELF_ROUND", "hold")
    _, (backend,), (plane,) = port_planes("none", n=1)
    m, b, g = _inputs()[0]
    assert plane.exchange(epoch=0, frag_id=0, idxs=[0, 1], masters=m, bufs=b, pgs=g) is None
    assert backend.last_round_health.get("dropped") is True


def test_async_failed_transfer_keeps_the_ef_residual(monkeypatch):
    """The partner is matched, then leaves before the transfer: the round
    drops, the residual is neither lost nor counted twice, and no mailbox
    deposit is left behind."""
    monkeypatch.setenv("ODTP_ASYNC_STALENESS", "2")
    world, backends, planes = port_planes("blockwise4bit", ef=True)
    assert all(r is not None and r[4] == 2 for r in run_pair(planes, (0, 0), _inputs()))
    mass = planes[0].residual_mass()
    state = planes[0].host_state()
    assert mass > 0.0
    res = [None]

    def flaky_partner():
        assert backends[1].async_pair_match(frag_id=0, epoch=1, window=2, patience=10.0) is not None
        backends[1].close()

    def survivor():
        m, b, g = _inputs()[0]
        res[0] = planes[0].exchange(epoch=1, frag_id=0, idxs=[0, 1], masters=m, bufs=b, pgs=g, timeout=5.0)

    ts = [threading.Thread(target=flaky_partner), threading.Thread(target=survivor)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert res[0] is None
    assert planes[0].residual_mass() == mass and _equal(planes[0].host_state()["peer-1"], state["peer-1"])
    h = backends[0].last_round_health
    assert h.get("dropped") is True and h["partner"] == "peer-1"
    assert not world._pairbox


def _exchange_trajectory(n_epochs=4):
    """Exchange and NoLoCo step for n epochs on two workers kept aligned by
    a barrier: each rank's final (masters, momentum)."""
    _, _, planes = port_planes("blockwise4bit")
    barrier = threading.Barrier(2, timeout=60)
    final, errors = [None, None], []

    def worker(rank):
        try:
            m, b = _leaves(rank), _leaves(10 + rank)
            for e in range(n_epochs):
                barrier.wait()
                res = planes[rank].exchange(epoch=e, frag_id=0, idxs=[0, 1], masters=m, bufs=b,
                                            pgs=_leaves(1000 + 10 * e + rank), timeout=30.0)
                assert res is not None and res[4] == 2
                m, b = noloco_step(res[0], res[1], res[2], lr=0.7, momentum=0.9, nesterov=True)
            final[rank] = (m, b)
        except Exception as e:  # pragma: no cover
            errors.append((rank, e))

    ts = [threading.Thread(target=worker, args=(r,)) for r in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    assert not errors, errors
    return final


def test_async_exchange_trajectory_equals_lockstep(monkeypatch):
    lockstep = _exchange_trajectory()
    monkeypatch.setenv("ODTP_ASYNC_STALENESS", "2")
    asynced = _exchange_trajectory()
    for rank in range(2):
        assert _equal(lockstep[rank][0] + lockstep[rank][1], asynced[rank][0] + asynced[rank][1])
    for mode in (lockstep, asynced):
        assert _equal(mode[0][0], mode[1][0])


@pytest.mark.parametrize("case", [dict(), dict(streaming_fragments=2, overlap_comm="eager")],
                         ids=["blocking", "streaming-eager"])
def test_async_training_equals_lockstep(tiny_cfg, monkeypatch, case):
    """Two port workers training with outer_mode="gossip": under async
    matching (patience long enough that the two always meet at the same
    epoch) the losses and masters equal the lockstep run bit for bit."""
    from test_diloco import make_trainer
    from test_torch_gossip import run_port

    params = jax.device_get(make_trainer(tiny_cfg).init_state(jax.random.key(7))["params"])
    kw = dict(local_steps=3, pin=True, compression="blockwise4bit", error_feedback=True, **case)
    lockstep = run_port(tiny_cfg, params, 2, 9, **kw)
    monkeypatch.setenv("ODTP_ASYNC_STALENESS", "2")
    monkeypatch.setenv("ODTP_ASYNC_PATIENCE_S", "30")
    asynced = run_port(tiny_cfg, params, 2, 9, **kw)
    for r in range(2):
        assert lockstep[r][0] == asynced[r][0]
        assert all(_equal(a, b) for a, b in zip(lockstep[r][1], asynced[r][1]))
        lags = [h["pair_lag"] for h in asynced[r][3].backend.round_ledger if h.get("gossip")]
        assert lags and set(lags) == {0}
