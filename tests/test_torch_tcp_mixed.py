"""Galaxies of JAX and port workers over real localhost sockets, on the CPU.

(c) Mixed groups: JAX ``TcpBackend``s (on the JAX package's native
library) and port ``TcpBackend``s (on the port's host library) in one
all-reduce, n in {2, 3}, every codec. Every peer's result equals every
other's bit for bit, and the butterfly model of ``test_torch_tcp.py``.
The two packages' native codecs are the same code (ROADMAP.md C4), so one
decoded value of every part is adopted galaxy-wide.

(d) A mixed training galaxy: one JAX worker (a single-device CPU mesh, as
``tests/test_diloco.py make_trainer`` builds one) and one port worker, in
threads, two outer rounds, codecs none and fp16, both loading one model
directory written from numpy weights. The averaged pseudo-gradient is
bit-identical on both sides every round, and each side's masters equal
the JAX-only galaxy's (two JAX workers over TCP, the same data) within
atol 1e-5, the tolerance ``tests/test_torch_train.py`` holds the
two-worker master trajectory to (f32 inner steps that differ only in the
order of their sums, times the outer step's lr 0.7 and momentum).
"""
import threading

import jax
import numpy as np
import pytest

from opendiloco_tpu import native as jnative
from opendiloco_tpu.config import DilocoConfig as JDilocoConfig
from opendiloco_tpu.diloco import DiLoCoOptimizer as JDiLoCoOptimizer
from opendiloco_tpu.diloco.rendezvous import RendezvousServer as JRendezvousServer
from opendiloco_tpu.diloco.tcp import TcpBackend as JTcpBackend
from opendiloco_tpu.models import hf_io as jhf_io
from opendiloco_torch.config import DilocoConfig
from opendiloco_torch.diloco import DiLoCoOptimizer
from opendiloco_torch.diloco.rendezvous import RendezvousServer
from opendiloco_torch.diloco.tcp import TcpBackend
from opendiloco_torch.models import hf_io as thf_io
from opendiloco_torch.models import llama as tllama
from opendiloco_torch.trainer import InnerTrainer, TrainerConfig
from test_torch_tcp import CODECS, assert_rounds_equal, butterfly, close_all, concurrent_allreduce, random_data

MIXES = {2: ["jp", "pj"], 3: ["pjp", "jpj"]}


@pytest.fixture
def jax_native():
    if not jnative.available():
        pytest.skip("the JAX package's native library is not built here")


def mixed_backends(address, mix, **kw):
    """One backend a letter of ``mix`` (j: JAX, p: port), worker-0 first."""
    cls = {"j": JTcpBackend, "p": TcpBackend}
    return [cls[c]([address], peer_id=f"worker-{i}", matchmaking_time=2.0, **kw) for i, c in enumerate(mix)]


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("mix", [m for n in (2, 3) for m in MIXES[n]])
def test_mixed_group_allreduce_bit_identical(jax_native, mix, codec):
    """The daemon is the package of worker-0's."""
    daemon = (JRendezvousServer if mix[0] == "j" else RendezvousServer)(host="127.0.0.1", port=0).start_in_thread()
    backends = mixed_backends(daemon.address, mix, compression=codec)
    try:
        data = random_data(len(mix), 31 + len(mix))
        assert_rounds_equal(concurrent_allreduce(backends, data), butterfly(data, codec), len(mix))
    finally:
        close_all(backends)
        daemon.stop()


@pytest.mark.parametrize("mode", ["adaptive", "hier", "serial"])
def test_mixed_group_adaptive_hier_and_serial_rounds(jax_native, mode, monkeypatch):
    """The planned rounds interoperate too: an adaptive (link-planned)
    round, a two-site hierarchical round and the serial whole-part path,
    four mixed peers, codec uniform8bit: every peer ends bit-identical and
    close to the mean."""
    if mode == "hier":
        monkeypatch.setenv("ODTP_HIER", "1")
        monkeypatch.setenv("ODTP_SITES", "worker-[01];worker-[23]")
    if mode == "serial":
        monkeypatch.setenv("ODTP_PIPELINE", "0")
    daemon = RendezvousServer(host="127.0.0.1", port=0).start_in_thread()
    backends = mixed_backends(daemon.address, "jpjp", compression="uniform8bit",
                              link_adapt=True if mode == "adaptive" else None)
    try:
        data = random_data(4, 41)
        for rnd in range(2):  # the second adaptive round plans from measured links
            results = concurrent_allreduce(backends, data, epoch=rnd)
            ref = results[0][0]
            for out, group in results:
                assert group == 4
                for o, r in zip(out, ref):
                    np.testing.assert_array_equal(o.view(np.uint32), r.view(np.uint32))
            mean = [np.mean([d[k] for d in data], axis=0) for k in range(len(data[0]))]
            for o, m in zip(ref, mean):
                np.testing.assert_allclose(o, m, atol=0.02 * np.abs(m).max())
        health = [b.last_round_health for b in backends]
        if mode == "hier":
            assert all("hier" in h for h in health)
            assert len({h["hier"]["plan"] for h in health}) == 1
        if mode == "adaptive":
            assert len({h["link_plan"] for h in health}) == 1
    finally:
        close_all(backends)
        daemon.stop()


# ---------------------------------------------------------------------------
# (d) a mixed training galaxy
# ---------------------------------------------------------------------------

STEPS, LOCAL_STEPS = 8, 4  # two outer rounds


def _recording(backend, log):
    """Keep a copy of every averaged pseudo-gradient the backend returns."""
    inner = backend.all_reduce

    def all_reduce(arrays, **kw):
        out, n = inner(arrays, **kw)
        log.append([np.array(o, np.float32, copy=True) for o in out])
        return out, n

    backend.all_reduce = all_reduce
    return backend


def _jax_worker(tiny_cfg, model_dir, backend, codec, rank, out):
    from test_diloco import batches, make_trainer

    trainer = make_trainer(tiny_cfg)
    state = trainer.init_state(jax.random.key(0), params=jhf_io.load_params(model_dir, tiny_cfg))
    cfg = JDilocoConfig(local_steps=LOCAL_STEPS, backend="tcp", compression=codec, outer_placement="host",
                        timeout_waiting_for_peers=30.0, averaging_timeout=60.0)
    opt = JDiLoCoOptimizer(trainer, backend, cfg, state, batch_size=8)
    for ids, labels in batches(1000 + rank, tiny_cfg.vocab_size, STEPS):
        state, _ = opt.step(state, trainer.shard_batch(ids, labels, accum=1))
        if opt.local_step == 0:
            out.append([m.copy() for m in opt.master])


def _port_worker(model_dir, backend, codec, rank, out):
    from test_diloco import batches

    cfg = thf_io.load_config(model_dir)
    tc = TrainerConfig(lr=1e-3, warmup_steps=2, total_steps=200, precision="fp32", remat=False)
    trainer = InnerTrainer(cfg, tc, device="cpu")
    state = trainer.init_state(params=thf_io.load_params(model_dir, cfg))
    dcfg = DilocoConfig(local_steps=LOCAL_STEPS, backend="tcp", compression=codec, outer_placement="host",
                        timeout_waiting_for_peers=30.0, averaging_timeout=60.0)
    opt = DiLoCoOptimizer(trainer, backend, dcfg, state, batch_size=8)
    for ids, labels in batches(1000 + rank, cfg.vocab_size, STEPS):
        state, _ = opt.step(state, trainer.shard_batch(ids, labels, accum=1))
        if opt.local_step == 0:
            out.append([m.copy() for m in opt.master])


def _galaxy(tiny_cfg, model_dir, kinds, codec):
    """Run one worker a kind ("jax" or "port") in threads over TCP; return
    each worker's (averaged pseudo-gradients, masters) by round."""
    daemon = RendezvousServer(host="127.0.0.1", port=0).start_in_thread()
    logs = [([], []) for _ in kinds]
    backends, errors = [], []
    try:
        for rank, kind in enumerate(kinds):
            cls = JTcpBackend if kind == "jax" else TcpBackend
            backends.append(_recording(cls([daemon.address], peer_id=f"worker-{rank}", compression=codec,
                                           matchmaking_time=10.0, expect_peers=len(kinds)), logs[rank][0]))

        def run(rank, kind):
            try:
                if kind == "jax":
                    _jax_worker(tiny_cfg, model_dir, backends[rank], codec, rank, logs[rank][1])
                else:
                    _port_worker(model_dir, backends[rank], codec, rank, logs[rank][1])
            except Exception as e:  # pragma: no cover
                errors.append((rank, e))

        threads = [threading.Thread(target=run, args=(r, k)) for r, k in enumerate(kinds)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not errors, errors
    finally:
        close_all(backends)
        daemon.stop()
    return logs


@pytest.mark.parametrize("codec", ["none", "fp16"])
def test_mixed_training_galaxy_matches_jax_galaxy(tiny_cfg, jax_native, codec, tmp_path):
    from test_diloco import make_trainer

    params = jax.device_get(make_trainer(tiny_cfg).init_state(jax.random.key(7))["params"])
    model_dir = str(tmp_path / "model")
    jhf_io.save_params(jax.tree.map(np.asarray, params), tiny_cfg, model_dir)

    (jgrads, jmasters), (tgrads, tmasters) = _galaxy(tiny_cfg, model_dir, ["jax", "port"], codec)
    assert len(jgrads) == len(tgrads) == 2 and len(jmasters) == len(tmasters) == 2
    for jg, tg in zip(jgrads, tgrads):  # every round's average, bit for bit
        for a, b in zip(jg, tg):
            assert a.shape == b.shape
            np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
    ref = _galaxy(tiny_cfg, model_dir, ["jax", "jax"], codec)
    for worker in ref:
        for rm, jm, tm in zip(worker[1], jmasters, tmasters):
            for r, a, b in zip(rm, jm, tm):
                np.testing.assert_allclose(a, r, atol=1e-5, rtol=0)
                np.testing.assert_allclose(b, r, atol=1e-5, rtol=0)
    # the port worker's leaves are in the JAX worker's order
    shapes = [m.shape for m in tmasters[0]]
    assert shapes == [m.shape for m in jmasters[0]]
    assert shapes == [tuple(p.shape) for p in tllama.flatten_params(thf_io.load_params(model_dir))]
