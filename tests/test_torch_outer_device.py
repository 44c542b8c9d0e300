"""The port's device-resident outer plane against its host placement and
against the JAX package, on the CPU.

The patterns of ``tests/test_outer_placement.py``. The same weights (the
JAX package's init, handed over as numpy) and the same numpy batches go
through the port with ``outer_placement="device"`` and ``"host"``, and
through the JAX package's two placements.

Tolerances, each with its reason:
- port device against port host: **equal bit for bit** (``np.array_equal``
  and float equality of the losses). The plane writes every update as
  separately rounded f32 operations in the host's order, so nothing may
  differ.
- port against the JAX package's host placement: losses rtol 1e-5,
  masters and momentum atol 1e-5, the tolerance of
  ``test_torch_train.py::test_two_worker_diloco_matches_jax_loopback`` for
  the same reason (the inner step's f32 sums run in another order in XLA
  and PyTorch, and the outer step scales those differences by lr 0.7 and
  momentum).
- port against the JAX package's device plane: the same, plus one fp16
  wire quantum (2^-11 relative) in the fp16-wire case: XLA fuses the
  Nesterov mul and add into an FMA there (the reference suite's own
  docstring), and an ulp upstream of the f16 cast can move a wire value
  by one quantum.
"""
import threading
import time

import jax
import numpy as np
import pytest
import torch

from opendiloco_tpu.diloco.compression import device_wire_dtype as jdevice_wire_dtype
from opendiloco_torch import ckpt as tckpt
from opendiloco_torch.config import DilocoConfig
from opendiloco_torch.diloco import DiLoCoOptimizer, LoopbackWorld, OuterSGD
from opendiloco_torch.diloco.compression import _CODECS, device_wire_dtype
from opendiloco_torch.diloco.outer_device import DeviceOuterPlane
from opendiloco_torch.models.llama import flatten_params
from opendiloco_torch.trainer import InnerTrainer, TrainerConfig
from test_outer_placement import batches
from test_outer_placement import make_trainer as jmake_trainer
from test_outer_placement import run_single as jrun_single

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def init_params(tiny_cfg):
    """The JAX package's init (key 7) as numpy, for both packages."""
    return jax.device_get(jmake_trainer(tiny_cfg).init_state(jax.random.key(7))["params"])


def port_trainer(tiny_cfg):
    return InnerTrainer(tiny_cfg, TrainerConfig(lr=1e-3, warmup_steps=2, total_steps=200, precision="fp32",
                                                remat=False), device="cpu")


def pin(opt, state, flush_streams=True):
    """Pin the landing schedule, as the reference suites do: wait for the
    overlapped round to resolve before the next step (both placements then
    land it at the same step), and land streaming rounds now (a round
    launched at the boundary step may or may not have resolved when the
    boundary looks)."""
    p = opt._pending
    if p is not None:
        while not p["future"].done():
            time.sleep(0.001)
    if flush_streams and opt._stream is not None:
        state = opt.flush(state)
    return state


def run_port(tiny_cfg, params, placement, *, n_steps=9, local_steps=3, overlap="none", compression="none",
             frags=0, avg_every=0, ef=False, backend=None, data_seed=0, pinned=True, **cfg_kw):
    """The port's side of ``test_outer_placement.run_single``: (losses,
    state, opt) after ``n_steps`` and a final flush; ``pinned``: the
    landing schedule pinned after every step (:func:`pin`)."""
    trainer = port_trainer(tiny_cfg)
    state = trainer.init_state(params=params)
    if backend is None:
        (backend,) = LoopbackWorld(1, compression=compression).make_backends()
    cfg = DilocoConfig(local_steps=local_steps, backend="loopback", outer_placement=placement, overlap_comm=overlap,
                       compression=compression, streaming_fragments=frags, average_state_every=avg_every,
                       error_feedback=ef, **cfg_kw)
    opt = DiLoCoOptimizer(trainer, backend, cfg, state, batch_size=8)
    losses = []
    for ids, labels in batches(data_seed, tiny_cfg.vocab_size, n_steps):
        state, m = opt.step(state, trainer.shard_batch(ids, labels, accum=1))
        losses.append(float(m["loss"]))
        if pinned:
            state = pin(opt, state)
    state = opt.flush(state)
    return losses, state, opt


def assert_same_state(a: dict, b: dict):
    """Two state dicts equal bit for bit: epoch, master, momentum and
    (where present) error-feedback residuals (None entries as zeros)."""
    assert a["epoch"] == b["epoch"]
    assert all(np.array_equal(x, y) for x, y in zip(a["master"], b["master"]))
    ba, bb = a["outer_opt"]["bufs"], b["outer_opt"]["bufs"]
    assert (ba is None) == (bb is None)
    if ba is not None:
        assert all(np.array_equal(x, y) for x, y in zip(ba, bb))
    ea, eb = a.get("ef_residual"), b.get("ef_residual")
    assert (ea is None) == (eb is None)
    if ea is not None:
        zero = lambda r, like: np.zeros_like(like) if r is None else np.asarray(r).reshape(like.shape)
        assert all(np.array_equal(zero(x, m), zero(y, m)) for x, y, m in zip(ea, eb, a["master"]))


def _make_opt(tiny_cfg, params, **cfg_kw):
    trainer = port_trainer(tiny_cfg)
    state = trainer.init_state(params=params)
    (backend,) = LoopbackWorld(1).make_backends()
    return trainer, state, DiLoCoOptimizer(trainer, backend, DilocoConfig(local_steps=3, backend="loopback",
                                                                          **cfg_kw), state, batch_size=8)


# ---------------------------------------------------------------------------
# placement resolution
# ---------------------------------------------------------------------------


def test_auto_resolves_host(tiny_cfg, init_params):
    _, _, opt = _make_opt(tiny_cfg, init_params, outer_placement="auto")
    assert opt.placement == "host" and opt._plane is None


def test_explicit_device_resolves_device(tiny_cfg, init_params):
    _, _, opt = _make_opt(tiny_cfg, init_params, outer_placement="device")
    assert opt.placement == "device" and opt._plane is not None
    assert opt.master == []  # no host mirror under device placement
    assert all(m.device.type == "cpu" and m.dtype == torch.float32 for m in opt._plane.masters)


def test_gossip_still_raises(tiny_cfg, init_params):
    """Gossip on the device plane was not ported before; now it builds: the
    plane holds master and momentum, and error feedback goes to the gossip
    plane's per-partner ledgers (the device plane keeps none).
    tests/test_torch_gossip.py holds its rounds to host placement."""
    _, _, opt = _make_opt(tiny_cfg, init_params, outer_placement="device", outer_mode="gossip",
                          compression="blockwise4bit", error_feedback=True)
    assert opt._plane is not None and opt._gossip is not None
    assert opt._plane.error_feedback is False and opt._ef is None and opt._gossip.error_feedback


# ---------------------------------------------------------------------------
# single-worker parity across every composition
# ---------------------------------------------------------------------------

_PARITY_CONFIGS = [
    pytest.param(dict(), id="blocking"),
    pytest.param(dict(overlap="delayed"), id="overlap-delayed"),
    pytest.param(dict(overlap="eager"), id="overlap-eager"),
    pytest.param(dict(compression="fp16"), id="fp16-wire"),
    pytest.param(dict(frags=3), id="streaming-fragments"),
    pytest.param(dict(avg_every=2), id="state-averaging"),
]


@pytest.mark.parametrize("kw", _PARITY_CONFIGS)
def test_placement_parity(tiny_cfg, init_params, kw):
    lh, _, oh = run_port(tiny_cfg, init_params, "host", **kw)
    ld, _, od = run_port(tiny_cfg, init_params, "device", **kw)
    assert oh.placement == "host" and od.placement == "device"
    assert lh == ld
    sh, sd = oh.state_dict(), od.state_dict()
    assert_same_state(sh, sd)
    # against the JAX package's two placements (tolerances: module docstring)
    fp16 = kw.get("compression") == "fp16"
    for jplacement, rtol in (("host", 0.0), ("device", 2.0**-11 if fp16 else 0.0)):
        jl, _, jo = jrun_single(tiny_cfg, jplacement, **kw)
        np.testing.assert_allclose(ld, jl, rtol=1e-5)
        jsd = jo.state_dict()
        assert jsd["epoch"] == sd["epoch"]
        for a, b in zip(sd["master"], jsd["master"]):
            np.testing.assert_allclose(a, b, rtol=rtol, atol=1e-5)
        jb = jsd["outer_opt"]["bufs"]
        assert (jb is None) == (sd["outer_opt"]["bufs"] is None)
        for a, b in zip(sd["outer_opt"]["bufs"] or [], jb or []):
            np.testing.assert_allclose(a, b, rtol=rtol, atol=1e-5)


def run_pair(tiny_cfg, params, placement, local_steps=2, n_steps=4, **cfg_kw):
    """Two loopback workers in threads, different data; their state dicts
    and losses."""
    backends = LoopbackWorld(2).make_backends()
    results, errors = [None, None], []

    def worker(rank):
        try:
            losses, _, opt = run_port(tiny_cfg, params, placement, n_steps=n_steps, local_steps=local_steps,
                                      backend=backends[rank], data_seed=1000 + rank, timeout_waiting_for_peers=30.0,
                                      averaging_timeout=60.0, **cfg_kw)
            results[rank] = (losses, opt.state_dict())
        except Exception as e:  # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors, errors
    return results


def test_multiworker_parity(tiny_cfg, init_params):
    """Two loopback workers on different data: the averaged outer
    trajectory is the same bit for bit under either placement, and the
    two workers' masters agree."""
    host = run_pair(tiny_cfg, init_params, "host")
    dev = run_pair(tiny_cfg, init_params, "device")
    for (lh, sh), (ld, sd) in zip(host, dev):
        assert lh == ld
        assert_same_state(sh, sd)
    assert all(np.array_equal(a, b) for a, b in zip(dev[0][1]["master"], dev[1][1]["master"]))


# ---------------------------------------------------------------------------
# state dicts, peers and checkpoints across placements
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("src,dst", [("device", "host"), ("host", "device"), ("device", "device")])
def test_state_dict_roundtrip_across_placements(tiny_cfg, init_params, tmp_path, src, dst):
    """A checkpoint written under either placement restores under either,
    through the port's checkpoint files, and the two continue alike."""
    _, state, opt = run_port(tiny_cfg, init_params, src, n_steps=6)
    sd = opt.state_dict()
    tckpt.save_checkpoint(str(tmp_path), 6, state, diloco_rank=0, diloco_state=sd)
    trainer = port_trainer(tiny_cfg)
    fresh = trainer.init_state(params=init_params)
    state2, sd_loaded, _, _ = tckpt.load_checkpoint(tckpt.ckpt_dir(str(tmp_path), 6, 0), fresh)
    (backend,) = LoopbackWorld(1).make_backends()
    opt2 = DiLoCoOptimizer(trainer, backend, DilocoConfig(local_steps=3, backend="loopback", outer_placement=dst),
                           state2, 8)
    opt2.load_state_dict(sd_loaded)
    assert_same_state(sd, opt2.state_dict())
    # both keep training, and stay equal
    for ids, labels in batches(5, tiny_cfg.vocab_size, 3):
        state, m = opt.step(state, opt.trainer.shard_batch(ids, labels, accum=1))
        state2, m2 = opt2.step(state2, trainer.shard_batch(ids, labels, accum=1))
        assert float(m["loss"]) == float(m2["loss"])
    assert opt2.epoch == opt.epoch == 3
    assert_same_state(opt.state_dict(), opt2.state_dict())


def test_serve_state_matches_state_dict_in_device_mode(tiny_cfg, init_params):
    """A peer's state fetch (host copies of the plane) publishes what the
    checkpoint writes."""
    _, _, opt = run_port(tiny_cfg, init_params, "device", n_steps=6)
    served = opt._state_for_peers()
    sd = opt.state_dict()
    assert served["epoch"] == sd["epoch"]
    assert all(isinstance(a, np.ndarray) and a.dtype == np.float32 for a in served["master"])
    assert_same_state({**sd, "outer_opt": served["outer_opt"], "master": served["master"]}, sd)


def test_load_state_from_peers_across_placements(tiny_cfg, init_params):
    """A device-placement joiner adopts a host-placement peer's state
    (and the reverse): master, momentum, epoch, the params at the master
    and the LR schedule at the swarm's position."""
    for src, dst in (("host", "device"), ("device", "host")):
        _, _, peer = run_port(tiny_cfg, init_params, src, n_steps=6)
        backend = peer.backend
        trainer = port_trainer(tiny_cfg)
        state = trainer.init_state(params=init_params)
        opt = DiLoCoOptimizer(trainer, backend, DilocoConfig(local_steps=3, backend="loopback",
                                                             outer_placement=dst), state, 8)
        backend.serve_state(peer._state_for_peers)
        state = opt.load_state_from_peers(state)
        assert opt.epoch == 2 and state["step"] == 6
        assert_same_state({**peer.state_dict(), "local_step": 0}, opt.state_dict())
        assert all(np.array_equal(p.detach().numpy(), m)
                   for p, m in zip(flatten_params(state["params"]), peer.state_dict()["master"]))


def test_ckpt_coerces_device_tensors(tiny_cfg, tmp_path):
    """The checkpoint's packing of a tree holding tensors equals that of
    its host view, byte for byte."""
    from opendiloco_torch.diloco import state_io

    t = [torch.arange(6, dtype=torch.float32).reshape(2, 3), torch.ones(4)]
    tree = {"master": t, "epoch": 4, "outer_opt": {"lr": 0.7, "momentum": 0.9, "nesterov": True, "bufs": None}}
    host = {**tree, "master": [x.numpy() for x in t]}
    (m1, a1), (m2, a2) = state_io.pack_state(tckpt._coerce_host(tree)), state_io.pack_state(host)
    assert m1 == m2 and all(x.tobytes() == y.tobytes() for x, y in zip(a1, a2))


# ---------------------------------------------------------------------------
# the plane alone
# ---------------------------------------------------------------------------


def _make_plane(params, momentum=0.9, compression="none"):
    leaves = [torch.from_numpy(np.array(x)) for x in jax.tree.leaves(params)]
    return DeviceOuterPlane(leaves, lr=0.7, momentum=momentum, nesterov=True, compression=compression), leaves


@pytest.mark.parametrize("momentum,nesterov", [(0.9, True), (0.9, False), (0.0, True)])
def test_plane_blocking_round_matches_outer_sgd(init_params, momentum, nesterov):
    plane, leaves = _make_plane(init_params, momentum=momentum)
    plane.nesterov = nesterov
    host_master = [x.numpy().copy() for x in leaves]
    opt = OuterSGD(0.7, momentum, nesterov=nesterov)
    rng = np.random.default_rng(0)
    for _ in range(3):
        fake = [rng.normal(scale=1e-3, size=m.shape).astype(np.float32) for m in host_master]
        opt.step(host_master, [f.copy() for f in fake])
        plane.apply_average([f.copy() for f in fake])
    got, bufs = plane.host_state()
    assert all(np.array_equal(a, b) for a, b in zip(host_master, got))
    if momentum:
        assert all(np.array_equal(a, b) for a, b in zip(opt.bufs, bufs))
    else:
        assert bufs is None


def test_plane_pseudo_grad(init_params):
    plane, leaves = _make_plane(init_params)
    moved = [x - 1e-3 for x in leaves]
    pg, kept, secs = plane.pseudo_grad(moved, keep_device=True)
    ref = [m.numpy() - p.numpy() for m, p in zip(plane.masters, moved)]
    assert all(np.array_equal(a, b) for a, b in zip(pg, ref))
    assert all(np.array_equal(k.numpy(), b) for k, b in zip(kept, ref))
    assert set(secs) == {"pseudo_grad_s", "d2h_s"}
    # host copies own their memory: a write to the device tensor leaves them
    kept[0].add_(1.0)
    assert np.array_equal(pg[0], ref[0])


def test_plane_fp16_wire_precast(init_params):
    """Under the plain fp16 codec the D2H carries f16: the host
    pseudo-gradient is exactly f16-representable, and its f16 bytes are
    those the host placement's encode makes."""
    for name in _CODECS:
        assert device_wire_dtype(name) == jdevice_wire_dtype(name), name
    plane, leaves = _make_plane(init_params, compression="fp16")
    moved = [x - 1e-3 for x in leaves]
    pg, _, _ = plane.pseudo_grad(moved)
    for g, m, p in zip(pg, plane.masters, moved):
        assert g.dtype == np.float32  # widened for the backend
        assert np.array_equal(g.astype(np.float16), (m.numpy() - p.numpy()).astype(np.float16))
        assert np.array_equal(g, g.astype(np.float16).astype(np.float32))


def test_plane_sync_params_copies(init_params):
    """params <- master is a copy: the trainer's in-place updates of its
    params leave the master alone."""
    plane, leaves = _make_plane(init_params)
    params = [torch.zeros_like(x) for x in leaves]
    plane.sync_params(params)
    for p, m in zip(params, plane.masters):
        assert torch.equal(p, m) and p.data_ptr() != m.data_ptr()
        p.add_(1.0)
    got, _ = plane.host_state()
    assert all(np.array_equal(g, x.numpy()) for g, x in zip(got, leaves))


def test_device_rounds_step_the_plane_in_place(tiny_cfg, init_params):
    """Blocking device rounds write the masters and momentum in place:
    after the first armed round the plane holds the same tensors."""
    trainer, state, opt = _make_opt(tiny_cfg, init_params, outer_placement="device")
    data = list(batches(0, tiny_cfg.vocab_size, 9))
    for ids, labels in data[:3]:
        state, _ = opt.step(state, trainer.shard_batch(ids, labels, accum=1))
    ptrs = [t.data_ptr() for t in opt._plane.masters + opt._plane.bufs]
    for ids, labels in data[3:]:
        state, _ = opt.step(state, trainer.shard_batch(ids, labels, accum=1))
    assert opt.epoch == 3
    assert [t.data_ptr() for t in opt._plane.masters + opt._plane.bufs] == ptrs


def test_plane_host_frag_and_sub_fused(init_params):
    """``host_frag`` copies one fragment's masters and momentum (momentum
    None until it arms); ``_sub_fused`` writes new - base into base."""
    from opendiloco_torch.diloco.outer_device import _sub_fused

    plane, leaves = _make_plane(init_params)
    m, b = plane.host_frag([0, 2])
    assert b is None and all(np.array_equal(x, leaves[i].numpy()) for x, i in zip(m, [0, 2]))
    plane.apply_average([np.full(x.shape, 1e-3, np.float32) for x in leaves])
    m, b = plane.host_frag([1])
    assert np.array_equal(m[0], plane.masters[1].numpy()) and np.array_equal(b[0], plane.bufs[1].numpy())
    base = [x.clone() for x in leaves]
    delta = _sub_fused(plane.masters, base)
    assert all(d is x for d, x in zip(delta, base))
    assert all(np.array_equal(d.numpy(), mm.numpy() - x.numpy()) for d, mm, x in zip(delta, plane.masters, leaves))
