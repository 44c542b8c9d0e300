"""The port's NoLoCo gossip rounds against the JAX package's, on the CPU.

The patterns of ``tests/test_gossip.py`` and of ``tests/test_diloco.py``'s
gossip cases, on the port's ``diloco/gossip.py``, its loopback wire and its
``DiLoCoOptimizer(outer_mode="gossip")``, each held against the JAX
package's copy of the same thing.

Tolerances, each with its reason:
- the pairing, the NoLoCo step, the staleness mix, both ends of a pair
  round, device against host placement, a resumed run against the run
  that did not stop, the capped loopback groups and a mixed JAX + port
  pair over sockets: **equal bit for bit**. Every one is numpy f32 in a
  fixed order (or the same tensor ops in the host's order), and a mixed
  galaxy needs exactly that. The JAX package's outer step may run a fused
  native kernel (``native.outer_sgd_step``, whose compiler may contract
  the multiply and add into an FMA); where the port is held against the
  JAX step bit for bit, the JAX side runs its numpy body, the one the
  port copies.
- port against JAX training trajectories: losses rtol 1e-5 and masters
  atol 1e-5, the tolerance of
  ``test_torch_train.py::test_two_worker_diloco_matches_jax_loopback``
  (the inner step's f32 sums run in another order in XLA and PyTorch).
  These runs move masters in f32 (``ODTP_STATE_CODEC=none``): the default
  fp16 state codec would round two masters that differ by that 1e-5 to
  different fp16 values.
"""
import json
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from opendiloco_tpu import native as jnative
from opendiloco_tpu.config import DilocoConfig as JDilocoConfig
from opendiloco_tpu.diloco import DiLoCoOptimizer as JDiLoCoOptimizer
from opendiloco_tpu.diloco import gossip as jgossip
from opendiloco_tpu.diloco import outer_optimizer as jouter
from opendiloco_tpu.diloco.loopback import LoopbackWorld as JLoopbackWorld
from opendiloco_tpu.diloco.rendezvous import RendezvousServer as JRendezvousServer
from opendiloco_tpu.diloco.tcp import TcpBackend as JTcpBackend
from opendiloco_torch import ckpt as tckpt
from opendiloco_torch.config import DilocoConfig
from opendiloco_torch.diloco import DiLoCoOptimizer, LoopbackWorld
from opendiloco_torch.diloco import gossip as tgossip
from opendiloco_torch.diloco import outer_optimizer as touter
from opendiloco_torch.diloco.tcp import TcpBackend
from opendiloco_torch.models.llama import flatten_params
from opendiloco_torch.trainer import InnerTrainer, TrainerConfig

torch.set_num_threads(2)


@pytest.fixture
def numpy_outer_step(monkeypatch):
    """The JAX outer step on its numpy body (see the module docstring)."""
    monkeypatch.setattr(jnative, "outer_sgd_step", lambda *a, **k: False)


@pytest.fixture(scope="module")
def init_params(tiny_cfg):
    from test_diloco import make_trainer

    return jax.device_get(make_trainer(tiny_cfg).init_state(jax.random.key(7))["params"])


# ---------------------------------------------------------------------------
# pair scheduling
# ---------------------------------------------------------------------------


def _member_sets():
    rng = np.random.default_rng(3)
    for n in (1, 2, 3, 4, 5, 8, 9, 16):
        yield [f"peer-{i}" for i in range(n)]
        yield [f"worker-{int(i)}" for i in rng.choice(1000, n, replace=False)]


def test_pair_schedule_equals_the_reference():
    for members in _member_sets():
        for seed in (0, 11):
            for key in ("f0-e0", "f0-e3", "f2-e7", "f1-e12"):
                want = jgossip.pair_schedule(members, key, seed=seed)
                assert tgossip.pair_schedule(list(reversed(members)), key, seed=seed) == want
                if len(members) % 2:
                    assert sum(x == y for x, y in want.items()) == 1  # one self-round


def test_pair_schedule_agrees_across_processes():
    members = [f"peer-{i}" for i in range(9)]
    code = ("import json\nfrom opendiloco_torch.diloco.gossip import pair_schedule\n"
            "print(json.dumps(pair_schedule([f'peer-{i}' for i in range(9)], 'f2-e7', seed=11)))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True, timeout=120)
    assert json.loads(out.stdout.strip()) == jgossip.pair_schedule(members, "f2-e7", seed=11)


def _matrix(members, rng):
    """A link matrix with capacities over six decades, some links unknown."""
    out = {}
    for p in members:
        peers = {q: {"bps": float(10 ** rng.uniform(5, 11))} for q in members if q != p and rng.random() < 0.7}
        out[p] = {"v": 1, "peers": peers}
    return out


@pytest.mark.parametrize("bias,floor", [("1.0", "0.25"), ("3.0", "0.05"), ("0", "0.25")])
def test_link_pair_weights_and_weighted_pairings_equal_the_reference(monkeypatch, bias, floor):
    monkeypatch.setenv("ODTP_GOSSIP_LINK_BIAS", bias)
    monkeypatch.setenv("ODTP_GOSSIP_LINK_FLOOR", floor)
    rng = np.random.default_rng(int(float(bias) * 10))
    for members in _member_sets():
        matrix = _matrix(members, rng)
        want = jgossip.link_pair_weights(matrix, members)
        got = tgossip.link_pair_weights(matrix, members)
        assert got == want
        for a in members[:3]:
            for b in members[-3:]:
                assert tgossip.pair_bps(matrix, a, b) == jgossip.pair_bps(matrix, a, b)
        for e in range(6):
            key = f"f0-e{e}"
            assert (tgossip.pair_schedule(members, key, weights=got, seed=2)
                    == jgossip.pair_schedule(members, key, weights=want, seed=2))
    assert tgossip.link_pair_weights(None, ["a", "b"]) is None


# ---------------------------------------------------------------------------
# the NoLoCo step and the staleness mix
# ---------------------------------------------------------------------------


def _arrays(seed, shapes=((4, 3), (7,), (2, 2, 2))):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _equal(a, b):
    return len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("momentum,nesterov,with_b", [(0.9, True, True), (0.9, True, False), (0.9, False, True),
                                                      (0.0, False, False)])
def test_noloco_step_equals_the_reference(numpy_outer_step, momentum, nesterov, with_b):
    mix_m, mix_b, avg_g = _arrays(0), _arrays(1) if with_b else None, _arrays(2)
    want = jouter.noloco_step(mix_m, mix_b, avg_g, lr=0.7, momentum=momentum, nesterov=nesterov)
    got = touter.noloco_step(mix_m, mix_b, avg_g, lr=0.7, momentum=momentum, nesterov=nesterov)
    assert _equal(got[0], want[0])
    assert (got[1] is None) == (want[1] is None)
    if want[1] is not None:
        assert _equal(got[1], want[1])


def test_step_mixed_indices_and_staleness_mix_equal_the_reference(numpy_outer_step):
    params, grads = _arrays(3), _arrays(4)
    jo, to = jouter.OuterSGD(), touter.OuterSGD()
    jp, tp = [p.copy() for p in params], [p.copy() for p in params]
    for r, idxs in enumerate(([0, 2], [1], [0, 1, 2])):
        mix_m = [_arrays(10 + r)[i] for i in idxs]
        mix_b = None if r == 0 else [_arrays(20 + r)[i] for i in idxs]
        g = [grads[i] * np.float32(r + 1) for i in idxs]
        jo.step_mixed_indices(jp, mix_m, mix_b, g, idxs)
        to.step_mixed_indices(tp, mix_m, mix_b, g, idxs)
        assert _equal(tp, jp) and _equal(to.bufs, jo.bufs)
    for d in range(4):
        for decay in (0.5, 0.8):
            w = jouter.staleness_weight(d, decay)
            assert touter.staleness_weight(d, decay) == w
            assert _equal(touter.staleness_mix(_arrays(5), _arrays(6), w), jouter.staleness_mix(_arrays(5),
                                                                                               _arrays(6), w))


# ---------------------------------------------------------------------------
# pair exchange through loopback backends
# ---------------------------------------------------------------------------


def _leaves(rank, shapes=((6, 4), (5,))):
    rng = np.random.default_rng(100 + rank)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def _inputs(momentum=True):
    return [(_leaves(r), _leaves(10 + r) if momentum else None, _leaves(20 + r)) for r in range(2)]


def run_pair(planes, inputs, epoch=0, frag_id=0, timeout=30.0):
    """Both workers' exchange() from two threads; per-rank results."""
    out = [None, None]

    def worker(rank):
        m, b, g = inputs[rank]
        out[rank] = planes[rank].exchange(epoch=epoch, frag_id=frag_id, idxs=list(range(len(m))), masters=m,
                                          bufs=b, pgs=g, timeout=timeout)

    ts = [threading.Thread(target=worker, args=(r,)) for r in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    return out


def test_exchange_none_codec_is_the_exact_pair_average(monkeypatch):
    monkeypatch.setenv("ODTP_STATE_CODEC", "none")
    backends = LoopbackWorld(2).make_backends()
    planes = [tgossip.GossipPlane(b, 2, compression="none") for b in backends]
    inputs = _inputs()
    out = run_pair(planes, inputs)
    (m0, b0, g0), (m1, b1, g1) = inputs
    for rank, (mix_m, mix_b, avg_g, partner, n) in enumerate(out):
        assert n == 2 and partner == backends[1 - rank].peer_id
        assert _equal(mix_m, [(a + b) * np.float32(0.5) for a, b in zip(m0, m1)])
        assert _equal(mix_b, [(a + b) * np.float32(0.5) for a, b in zip(b0, b1)])
        assert _equal(avg_g, [(a + b) * np.float32(0.5) for a, b in zip(g0, g1)])
        h = backends[rank].last_round_health
        assert h["gossip"] and h["group_size"] == 2 and h["partner"] == backends[1 - rank].peer_id
        assert h["wire_bytes"] > 0 and backends[rank].round_ledger[-1] is h


@pytest.mark.parametrize("compression", ["blockwise4bit", "topk", "uniform8bit"])
def test_exchange_lossy_codecs_both_sides_and_the_reference_agree(compression):
    """Both ends decode both frames and average in sorted-pair order, so
    they hold the same bits; and a JAX pair given the same inputs ends
    with those bits too."""
    inputs = _inputs()
    planes = [tgossip.GossipPlane(b, 2, compression=compression) for b in LoopbackWorld(2).make_backends()]
    out = run_pair(planes, inputs)
    jplanes = [jgossip.GossipPlane(b, 2, compression=compression) for b in JLoopbackWorld(2).make_backends()]
    jout = run_pair(jplanes, inputs)
    for k in range(3):
        assert _equal(out[0][k], out[1][k])
        assert _equal(out[0][k], jout[0][k])


def test_exchange_partner_death_drops_the_round_and_keeps_the_residual():
    world = LoopbackWorld(2)
    backends = world.make_backends()
    planes = [tgossip.GossipPlane(b, 2, compression="blockwise4bit", error_feedback=True) for b in backends]
    assert all(r is not None for r in run_pair(planes, _inputs()))
    mass = planes[0].residual_mass()
    assert mass > 0.0
    state = planes[0].host_state()
    backends[1].close()
    # worker 0's membership view is stale: it still schedules the pair
    backends[0].gossip_view = lambda: ([b.peer_id for b in backends], None)
    m, b, g = _inputs()[0]
    assert planes[0].exchange(epoch=1, frag_id=0, idxs=[0, 1], masters=m, bufs=b, pgs=g, timeout=5.0) is None
    assert planes[0].residual_mass() == mass
    assert _equal(planes[0].host_state()["peer-1"], state["peer-1"])
    assert backends[0].last_round_health.get("dropped") is True
    assert not world._pairbox  # no abandoned deposit left behind


def test_self_round_policies(monkeypatch):
    (backend,) = LoopbackWorld(1).make_backends()
    m, b, g = _inputs()[0]
    mix_m, mix_b, avg_g, partner, n = tgossip.GossipPlane(backend, 2, compression="blockwise4bit").exchange(
        epoch=0, frag_id=0, idxs=[0, 1], masters=m, bufs=b, pgs=g)
    assert n == 1 and partner == backend.peer_id
    assert _equal(mix_m + mix_b + avg_g, m + b + g)  # no codec on a self-round
    monkeypatch.setenv("ODTP_GOSSIP_SELF_ROUND", "hold")
    held = tgossip.GossipPlane(backend, 2, compression="none")
    assert held.exchange(epoch=1, frag_id=0, idxs=[0, 1], masters=m, bufs=b, pgs=g) is None
    assert backend.last_round_health.get("dropped") is True


# ---------------------------------------------------------------------------
# capped loopback groups
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,cap", [(5, 2), (4, 3)])
def test_capped_loopback_groups_equal_the_reference(n, cap):
    data = [_arrays(40 + r) for r in range(n)]

    def run(world):
        backends = world.make_backends()
        out = [None] * n

        def worker(r):
            out[r] = backends[r].all_reduce(data[r], epoch=3, group_cap=cap, timeout=30.0)

        ts = [threading.Thread(target=worker, args=(r,)) for r in range(n)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        return out, backends

    got, tb = run(LoopbackWorld(n, compression="uniform8bit"))
    want, jb = run(JLoopbackWorld(n, compression="uniform8bit"))
    for (ta, tn), (ja, jn) in zip(got, want):
        assert tn == jn <= cap and _equal(ta, ja)
    assert sorted(x[1] for x in got) == sorted(x[1] for x in want)
    assert [b.last_round_health for b in tb] == [b.last_round_health for b in jb]


# ---------------------------------------------------------------------------
# training galaxies
# ---------------------------------------------------------------------------


def port_trainer(tiny_cfg):
    return InnerTrainer(tiny_cfg, TrainerConfig(lr=1e-3, warmup_steps=2, total_steps=200, precision="fp32",
                                                remat=False), device="cpu")


def host_masters(opt):
    return opt._plane.host_state()[0] if opt._plane is not None else [m.copy() for m in opt.master]


def run_port(tiny_cfg, params, n_workers, n_steps, *, local_steps=4, pin=False, backends=None, stop_after=None,
             **cfg_kw):
    """Port gossip workers in threads on one loopback world: per worker
    (losses, masters at each boundary, final masters, optimizer, state).
    ``pin`` lands streaming rounds after every step (the landing schedule
    is then the same run to run)."""
    from test_diloco import batches

    if backends is None:
        backends = LoopbackWorld(n_workers).make_backends()
    results, errors = [None] * n_workers, []

    def worker(rank):
        try:
            trainer = port_trainer(tiny_cfg)
            state = trainer.init_state(params=params)
            cfg = DilocoConfig(local_steps=local_steps, backend="loopback", outer_mode="gossip",
                               timeout_waiting_for_peers=30.0, averaging_timeout=60.0, **cfg_kw)
            opt = DiLoCoOptimizer(trainer, backends[rank], cfg, state, batch_size=8)
            losses, rounds = [], []
            for ids, labels in batches(1000 + rank, tiny_cfg.vocab_size, n_steps):
                state, m = opt.step(state, trainer.shard_batch(ids, labels, accum=1))
                losses.append(float(m["loss"]))
                if pin and opt._stream is not None:
                    state = opt.flush(state)
                if opt.local_step == 0:
                    rounds.append(host_masters(opt))
            state = opt.flush(state)
            results[rank] = (losses, rounds, host_masters(opt), opt, state, trainer)
        except Exception as e:  # pragma: no cover - surfaced below
            errors.append((rank, e))

    ts = [threading.Thread(target=worker, args=(r,)) for r in range(n_workers)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=300)
    assert not errors, errors
    return results


def run_jax(tiny_cfg, n_workers, n_steps, *, local_steps=4, **cfg_kw):
    """The JAX package's gossip workers on the same data: per worker
    (losses, masters at each boundary)."""
    from test_diloco import batches, make_trainer

    backends = JLoopbackWorld(n_workers).make_backends()
    results, errors = [None] * n_workers, []

    def worker(rank):
        try:
            trainer = make_trainer(tiny_cfg)
            state = trainer.init_state(jax.random.key(7))
            cfg = JDilocoConfig(local_steps=local_steps, backend="loopback", outer_mode="gossip",
                                timeout_waiting_for_peers=30.0, averaging_timeout=60.0, **cfg_kw)
            opt = JDiLoCoOptimizer(trainer, backends[rank], cfg, state, batch_size=8)
            losses, rounds = [], []
            for ids, labels in batches(1000 + rank, tiny_cfg.vocab_size, n_steps):
                state, m = opt.step(state, trainer.shard_batch(ids, labels, accum=1))
                losses.append(float(m["loss"]))
                if opt.local_step == 0:
                    rounds.append([x.copy() for x in opt.master])
            results[rank] = (losses, rounds)
        except Exception as e:  # pragma: no cover
            errors.append((rank, e))

    ts = [threading.Thread(target=worker, args=(r,)) for r in range(n_workers)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=300)
    assert not errors, errors
    return results


def test_two_workers_gossip_equals_full_sync(tiny_cfg, init_params, monkeypatch):
    """Two workers: each round's pair is the whole swarm. Their masters
    stay equal bit for bit, and with f32 masters on the wire the run
    equals all-reduce DiLoCo bit for bit ((a + b) * 0.5 is a + b over 2)."""
    from test_torch_train import _torch_diloco_workers

    monkeypatch.setenv("ODTP_STATE_CODEC", "none")
    res = run_port(tiny_cfg, init_params, 2, 8)
    (l0, r0, m0, opt0, *_), (l1, r1, m1, opt1, *_) = res
    assert opt0.epoch == opt1.epoch == 2
    assert all(_equal(a, b) for a, b in zip(r0, r1)) and len(r0) == 2
    assert all(h["group_size"] == 2 and h["gossip"] for h in opt0.backend.round_ledger)
    full, full_masters = _torch_diloco_workers(tiny_cfg, init_params, 2, 8, 4)
    for rank, (losses, *_rest) in enumerate(res):
        assert losses == list(full[rank][0])
        assert all(_equal(a, b) for a, b in zip(res[rank][1], full_masters[rank]))


def test_four_workers_mix_and_learn(tiny_cfg, init_params):
    res = run_port(tiny_cfg, init_params, 4, 8)
    flat = []
    for losses, _, masters, opt, *_ in res:
        assert opt.epoch == 2 and opt.last_outer_metrics["num_peers"] <= 2
        assert all(np.isfinite(x).all() for x in masters) and np.isfinite(losses).all()
        assert all(h["group_size"] == 2 for h in opt.backend.round_ledger)
        flat.append(np.concatenate([x.ravel() for x in masters]))
    scale = max(np.abs(f).max() for f in flat)
    assert max(np.abs(a - b).max() for i, a in enumerate(flat) for b in flat[i + 1:]) < 0.5 * scale
    # the masters moved off the init: the galaxy trained
    init = np.concatenate([np.asarray(x).ravel() for x in jax.tree.leaves(init_params)])
    assert all(np.abs(f - init).max() > 0 for f in flat)


@pytest.mark.parametrize("n_workers", [2, 3])
def test_port_and_jax_gossip_trajectories_agree(tiny_cfg, init_params, monkeypatch, n_workers):
    """Three workers: an odd galaxy, one self-round a round."""
    monkeypatch.setenv("ODTP_STATE_CODEC", "none")
    port = run_port(tiny_cfg, init_params, n_workers, 8)
    ref = run_jax(tiny_cfg, n_workers, 8)
    for (tl, tr, *_), (jl, jr) in zip(port, ref):
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
        assert len(tr) == len(jr) == 2
        for tm, jm in zip(tr, jr):
            for a, b in zip(tm, jm):
                np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
    if n_workers == 3:
        selfs = [h for _, _, _, opt, *_ in port for h in opt.backend.round_ledger if h["group_size"] == 1]
        assert len(selfs) == 2  # one a round


_PLACEMENT_CASES = [
    pytest.param(dict(), id="blocking"),
    pytest.param(dict(compression="blockwise4bit", error_feedback=True), id="blockwise4bit-ef"),
    pytest.param(dict(streaming_fragments=2), id="blocking-fragments"),
    pytest.param(dict(streaming_fragments=2, overlap_comm="eager", compression="fp16"), id="streaming-eager"),
    pytest.param(dict(streaming_fragments=2, overlap_comm="delayed"), id="streaming-delayed"),
]


@pytest.mark.parametrize("case", _PLACEMENT_CASES)
def test_two_workers_agree_and_device_placement_equals_host(tiny_cfg, init_params, case):
    """Both workers end every round with the same masters, and device
    placement repeats host placement's losses and masters bit for bit."""
    host = run_port(tiny_cfg, init_params, 2, 9, local_steps=3, pin=True, outer_placement="host", **case)
    dev = run_port(tiny_cfg, init_params, 2, 9, local_steps=3, pin=True, outer_placement="device", **case)
    assert dev[0][3]._plane is not None and host[0][3]._plane is None
    assert len(host[0][1]) == 3
    for r in range(2):
        assert host[r][0] == dev[r][0]
        assert all(_equal(a, b) for a, b in zip(host[r][1], dev[r][1]))
        assert _equal(host[r][2], dev[r][2])
        hp = [p.detach().numpy() for p in flatten_params(host[r][4]["params"])]
        dp = [p.detach().numpy() for p in flatten_params(dev[r][4]["params"])]
        assert _equal(hp, dp)
    for a, b in zip(host[0][1], host[1][1]):
        assert _equal(a, b)
    if case.get("error_feedback"):
        sd = host[0][3].state_dict()
        assert "ef_residual" not in sd and set(sd["gossip_ef"]) == {"peer-1"}
        assert host[0][3]._ef is None and dev[0][3]._plane.error_feedback is False


def test_gossip_ef_survives_a_checkpoint_bit_for_bit(tiny_cfg, init_params):
    """Stop both workers after two rounds, pack each optimizer's state as a
    checkpoint does, resume in fresh optimizers on a fresh world: the last
    round equals the run that did not stop, bit for bit."""
    from test_diloco import batches

    kw = dict(local_steps=3, compression="blockwise4bit", error_feedback=True)
    full = run_port(tiny_cfg, init_params, 2, 9, **kw)
    first = run_port(tiny_cfg, init_params, 2, 6, **kw)
    sds = []
    for rank, (_, _, _, opt, _, _) in enumerate(first):
        meta, blob = tckpt._pack_tree(opt.state_dict())
        sd = tckpt._unpack_tree(json.loads(json.dumps(meta)), blob)
        assert list(sd["gossip_ef"]) == [f"peer-{1 - rank}"]  # one ledger, the partner's
        sds.append(sd)
        opt.backend.close()
    backends = LoopbackWorld(2).make_backends()
    out, errors = [None, None], []

    def worker(rank):
        try:
            _, _, _, _, state, trainer = first[rank]
            cfg = DilocoConfig(backend="loopback", outer_mode="gossip", timeout_waiting_for_peers=30.0,
                               averaging_timeout=60.0, **kw)
            opt = DiLoCoOptimizer(trainer, backends[rank], cfg, state, batch_size=8)
            opt.load_state_dict(sds[rank])
            losses = []
            for ids, labels in list(batches(1000 + rank, tiny_cfg.vocab_size, 9))[6:]:
                state, m = opt.step(state, trainer.shard_batch(ids, labels, accum=1))
                losses.append(float(m["loss"]))
            out[rank] = (losses, host_masters(opt))
        except Exception as e:  # pragma: no cover
            errors.append(e)

    ts = [threading.Thread(target=worker, args=(r,)) for r in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    assert not errors, errors
    for r in range(2):
        assert out[r][0] == full[r][0][6:]
        assert _equal(out[r][1], full[r][2])


# ---------------------------------------------------------------------------
# a mixed JAX + port galaxy over real sockets
# ---------------------------------------------------------------------------


def test_mixed_jax_and_port_gossip_over_sockets(tiny_cfg, init_params, numpy_outer_step):
    """A JAX worker and a port worker, each on its package's TcpBackend,
    meet at the port's rendezvous daemon and gossip through
    ``pair_exchange`` (blockwise4bit with error feedback, fp16 masters):
    after every round both hold the same masters bit for bit."""
    from test_diloco import batches, make_trainer

    daemon = JRendezvousServer(host="127.0.0.1", port=0).start_in_thread()
    kw = dict(local_steps=3, backend="tcp", outer_mode="gossip", compression="blockwise4bit", error_feedback=True,
              timeout_waiting_for_peers=30.0, averaging_timeout=180.0, outer_placement="host")
    backends = [JTcpBackend([daemon.address], peer_id="worker-0", matchmaking_time=2.0, expect_peers=2),
                TcpBackend([daemon.address], peer_id="worker-1", matchmaking_time=2.0, expect_peers=2)]
    rounds, errors = [[], []], []

    def jax_worker():
        trainer = make_trainer(tiny_cfg)
        state = trainer.init_state(jax.random.key(7))
        opt = JDiLoCoOptimizer(trainer, backends[0], JDilocoConfig(**kw), state, batch_size=8)
        for ids, labels in batches(1000, tiny_cfg.vocab_size, 9):
            state, _ = opt.step(state, trainer.shard_batch(ids, labels, accum=1))
            if opt.local_step == 0:
                rounds[0].append(([m.copy() for m in opt.master], [b.copy() for b in opt.outer_opt.bufs]))

    def port_worker():
        trainer = port_trainer(tiny_cfg)
        state = trainer.init_state(params=init_params)
        opt = DiLoCoOptimizer(trainer, backends[1], DilocoConfig(**kw), state, batch_size=8)
        for ids, labels in batches(1001, tiny_cfg.vocab_size, 9):
            state, _ = opt.step(state, trainer.shard_batch(ids, labels, accum=1))
            if opt.local_step == 0:
                rounds[1].append(([m.copy() for m in opt.master], [b.copy() for b in opt.outer_opt.bufs]))

    def run(fn):
        try:
            fn()
        except Exception as e:  # pragma: no cover
            errors.append(e)

    ts = [threading.Thread(target=run, args=(f,)) for f in (jax_worker, port_worker)]
    try:
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=300)
    finally:
        for b in backends:
            b.close()
        daemon.stop()
    assert not errors, errors
    assert len(rounds[0]) == len(rounds[1]) == 3
    for (jm, jb), (tm, tb) in zip(*rounds):
        assert _equal(jm, tm) and _equal(jb, tb)
    gossip_rounds = [h for h in backends[1].round_ledger if h.get("gossip")]
    assert len(gossip_rounds) == 3 and all(h["group_size"] == 2 and h["partner"] == "worker-0"
                                           for h in gossip_rounds)
