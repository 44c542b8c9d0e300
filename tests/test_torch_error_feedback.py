"""Error feedback of the port (``diloco/error_feedback.py`` and its hooks
in the optimizer, the device plane and the streaming scheduler), on the
CPU.

The patterns of ``tests/test_error_feedback.py`` (all but the wire
counters, which come with the observability counters): each round's codec
round trip error is staged at prepare, adopted at commit, dropped at
abort with the previous residual kept; residuals survive checkpoints
across placements and streaming fragments. Beside them: the port's
ledger equals the JAX package's bit for bit on the same pseudo-gradients,
device placement equals host placement bit for bit (blocking, fragments,
streaming x eager), and the DiLoCo sidecar with ``ef_residual`` is the
JAX package's byte for byte.
"""
import json

import jax
import numpy as np
import pytest
import torch

from opendiloco_tpu import ckpt as jckpt
from opendiloco_tpu.diloco.compression import get_codec as jget_codec
from opendiloco_tpu.diloco.error_feedback import ErrorFeedback as JErrorFeedback
from opendiloco_torch import ckpt as tckpt
from opendiloco_torch.config import DilocoConfig
from opendiloco_torch.diloco import DiLoCoOptimizer, LoopbackWorld
from opendiloco_torch.diloco.compression import get_codec
from opendiloco_torch.diloco.error_feedback import ErrorFeedback
from opendiloco_torch.diloco.outer_device import DeviceOuterPlane
from test_outer_placement import batches
from test_torch_outer_device import assert_same_state, init_params, port_trainer, run_port  # noqa: F401

torch.set_num_threads(2)


def run_ef(tiny_cfg, params, placement, *, n_steps=6, local_steps=3, frags=0, compression="blockwise4bit",
           **kw):
    return run_port(tiny_cfg, params, placement, n_steps=n_steps, local_steps=local_steps, frags=frags,
                    compression=compression, ef=True, **kw)


def _residuals(opt):
    if opt.placement == "device":
        return opt._plane.ef_host_state()
    return opt._ef.host_residuals()


# ---------------------------------------------------------------------------
# the ledger
# ---------------------------------------------------------------------------


def test_ef_prepare_commit_abort():
    ef = ErrorFeedback(get_codec("blockwise4bit"), 2)
    rng = np.random.default_rng(0)
    g = [rng.normal(size=(8, 513)).astype(np.float32) for _ in range(2)]
    pgs = [x.copy() for x in g]
    ef.prepare("main", [0, 1], pgs)
    assert all(np.array_equal(a, b) for a, b in zip(pgs, g))  # no residual yet
    assert ef.residual[0] is None  # nothing adopted before commit
    ef.commit("main")
    r1 = [ef.residual[i].copy() for i in range(2)]
    for r, x in zip(r1, g):
        assert np.isfinite(r).all() and np.abs(r).max() > 0
        assert np.abs(r).max() <= np.abs(x).max() / 7.0  # half a 4-bit bin
    pgs2 = [x.copy() for x in g]
    ef.prepare("main", [0, 1], pgs2)
    assert all(np.array_equal(a, b + r.reshape(b.shape)) for a, b, r in zip(pgs2, g, r1))
    ef.commit("main")
    r2 = [ef.residual[i].copy() for i in range(2)]
    ef.prepare("main", [0, 1], [x.copy() for x in g])
    ef.abort("main")
    assert ef._pending == {}
    assert all(np.array_equal(ef.residual[i], r2[i]) for i in range(2))
    ef.commit("main")  # nothing staged: no-op
    assert all(np.array_equal(ef.residual[i], r2[i]) for i in range(2))


@pytest.mark.parametrize("name", ["blockwise4bit", "topk"])
def test_ef_mass_conservation(name):
    """Over N rounds of a constant gradient g, what went on the wire plus
    the final residual is N * g: compression delays signal, never loses
    it (tolerance: f32 sums of five rounds, the reference's)."""
    ef = ErrorFeedback(get_codec(name), 1)
    g = np.random.default_rng(5).normal(size=5000).astype(np.float32)
    total = np.zeros_like(g)
    for _ in range(5):
        pg = g.copy()
        ef.prepare("main", [0], [pg])
        total += pg - ef._pending["main"][1][0].reshape(pg.shape)
        ef.commit("main")
    total += ef.residual[0].reshape(g.shape)
    np.testing.assert_allclose(total, 5 * g, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", ["blockwise4bit", "topk", "fp16", "blockwise8bit"])
def test_ef_ledger_is_the_jax_packages(name):
    """The same pseudo-gradients through both ledgers: the pg with its
    residual and every committed residual equal bit for bit."""
    tef, jef = ErrorFeedback(get_codec(name), 2), JErrorFeedback(jget_codec(name), 2)
    rng = np.random.default_rng(1)
    for r in range(4):
        g = [rng.normal(size=s).astype(np.float32) for s in ((64, 130), (4100,))]
        tp, jp = [x.copy() for x in g], [x.copy() for x in g]
        tef.prepare("main", [0, 1], tp)
        jef.prepare("main", [0, 1], jp)
        assert all(np.array_equal(a, b) for a, b in zip(tp, jp))
        if r == 2:
            tef.abort("main")
            jef.abort("main")
        else:
            tef.commit("main")
            jef.commit("main")
        assert all(np.array_equal(a, b) for a, b in zip(tef.residual, jef.residual))


def test_config_rejects_unsupported_ef_combos(tiny_cfg, init_params):
    DilocoConfig(local_steps=3, backend="loopback", compression="blockwise4bit", error_feedback=True)
    with pytest.raises(ValueError):
        DilocoConfig(local_steps=3, backend="loopback", compression="none", error_feedback=True)
    # gossip keeps its residuals per partner, in the gossip plane
    trainer = port_trainer(tiny_cfg)
    state = trainer.init_state(params=init_params)
    cfg = DilocoConfig(local_steps=3, backend="loopback", compression="blockwise4bit", error_feedback=True,
                       outer_mode="gossip")
    opt = DiLoCoOptimizer(trainer, LoopbackWorld(1).make_backends()[0], cfg, state, 8)
    assert opt._ef is None and opt._gossip.error_feedback and opt._gossip.codec.name == "blockwise4bit"


# ---------------------------------------------------------------------------
# the device plane's residuals
# ---------------------------------------------------------------------------


def _plane_ef(params, compression):
    leaves = [torch.from_numpy(np.array(x)) for x in jax.tree.leaves(params)]
    return DeviceOuterPlane(leaves, lr=0.7, momentum=0.9, nesterov=True, compression=compression,
                            error_feedback=True), leaves


def test_plane_ef_forces_full_width_wire(init_params):
    plane, _ = _plane_ef(init_params, "fp16")
    assert plane._wire_dtype is None


def test_plane_ef_pseudo_grad_includes_residual(init_params):
    plane, leaves = _plane_ef(init_params, "blockwise4bit")
    moved = [x - 1e-3 for x in leaves]
    pg0, _, _ = plane.pseudo_grad(moved)  # residuals start as zeros
    res = [np.full(m.shape, 1e-2, np.float32) for m in plane.masters]
    plane.set_ef_residuals(range(len(res)), res)
    assert all(np.array_equal(a, b) for a, b in zip(plane.ef_host_state(), res))
    pg1, _, _ = plane.pseudo_grad(moved)
    # (master - params) + residual, one rounding each: the host's order
    assert all(np.array_equal(a, b + r) for a, b, r in zip(pg1, pg0, res))
    plane.load_ef(None)
    assert plane.ef_res is None
    pg2, _, _ = plane.pseudo_grad(moved)
    assert all(np.array_equal(a, b) for a, b in zip(pg2, pg0))


# ---------------------------------------------------------------------------
# rounds under both placements
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("placement,frags", [("host", 0), ("device", 0), ("host", 3), ("device", 3)],
                         ids=["host-blocking", "device-blocking", "host-streaming", "device-streaming"])
def test_ef_rounds_populate_residual(tiny_cfg, init_params, placement, frags):
    losses, _, opt = run_ef(tiny_cfg, init_params, placement, frags=frags)
    assert all(np.isfinite(x) for x in losses) and opt.epoch >= 1
    res = _residuals(opt)
    assert res is not None and any(r is not None and np.abs(r).max() > 0 for r in res)
    assert opt.state_dict().get("ef_residual") is not None


@pytest.mark.parametrize("kw", [dict(), dict(frags=3), dict(frags=3, overlap="eager", compression="uniform8bit"),
                                dict(overlap="delayed"), dict(overlap="eager", compression="topk")],
                         ids=["blocking", "fragments", "streaming-eager-uniform8bit", "overlap-delayed",
                              "overlap-eager-topk"])
def test_ef_device_equals_host(tiny_cfg, init_params, kw):
    """Losses, masters, momentum and residuals bit for bit across
    placements."""
    lh, _, oh = run_ef(tiny_cfg, init_params, "host", n_steps=9, **kw)
    ld, _, od = run_ef(tiny_cfg, init_params, "device", n_steps=9, **kw)
    assert lh == ld
    sh, sd = oh.state_dict(), od.state_dict()
    assert sh["ef_residual"] is not None
    assert_same_state(sh, sd)


@pytest.mark.parametrize("src,dst", [("device", "host"), ("host", "device")])
def test_ef_state_dict_roundtrip_across_placements(tiny_cfg, init_params, src, dst):
    _, _, opt = run_ef(tiny_cfg, init_params, src)
    sd = opt.state_dict()
    assert sd["ef_residual"] is not None
    trainer = port_trainer(tiny_cfg)
    state = trainer.init_state(params=init_params)
    (backend,) = LoopbackWorld(1, compression="blockwise4bit").make_backends()
    opt2 = DiLoCoOptimizer(trainer, backend, DilocoConfig(local_steps=3, backend="loopback", outer_placement=dst,
                                                          compression="blockwise4bit", error_feedback=True),
                           state, 8)
    opt2.load_state_dict(sd)
    res2 = _residuals(opt2)
    for a, b in zip(sd["ef_residual"], res2):
        assert np.array_equal(np.asarray(a, np.float32), b)
    for ids, labels in batches(5, tiny_cfg.vocab_size, 3):
        state, m = opt2.step(state, trainer.shard_batch(ids, labels, accum=1))
        assert np.isfinite(float(m["loss"]))
    assert opt2.epoch == opt.epoch + 1


@pytest.mark.parametrize("placement", ["host", "device"])
def test_ef_residual_survives_dropped_round(tiny_cfg, init_params, placement):
    """A wire failure at the boundary aborts the staged errors and keeps
    the last committed residual; the next boundary commits again."""
    trainer = port_trainer(tiny_cfg)
    state = trainer.init_state(params=init_params)
    (backend,) = LoopbackWorld(1, compression="blockwise4bit").make_backends()
    cfg = DilocoConfig(local_steps=3, backend="loopback", outer_placement=placement, compression="blockwise4bit",
                       error_feedback=True)
    opt = DiLoCoOptimizer(trainer, backend, cfg, state, batch_size=8)
    data = list(batches(0, tiny_cfg.vocab_size, 9))
    for ids, labels in data[:5]:  # round 1 commits; two inner steps more
        state, _ = opt.step(state, trainer.shard_batch(ids, labels, accum=1))
    assert opt.epoch == 1
    r1 = [r.copy() for r in _residuals(opt)]
    real = backend.all_reduce
    backend.all_reduce = lambda *a, **k: (_ for _ in ()).throw(RuntimeError("injected wire failure"))
    with pytest.raises(RuntimeError, match="injected wire failure"):
        opt.outer_step(state)
    assert opt.epoch == 1 and opt._ef._pending == {}
    assert all(np.array_equal(a, b) for a, b in zip(_residuals(opt), r1))
    backend.all_reduce = real
    state, m = opt.step(state, trainer.shard_batch(*data[5], accum=1))
    assert np.isfinite(float(m["loss"])) and opt.epoch == 2
    assert any(not np.array_equal(a, b) for a, b in zip(_residuals(opt), r1))


@pytest.mark.parametrize("placement", ["host", "device"])
def test_ef_sidecar_is_the_jax_packages(tiny_cfg, init_params, tmp_path, placement):
    """The checkpoint's DiLoCo sidecar with ``ef_residual`` (host placement:
    None for the leaves of fragments that never committed) is the JAX
    package's ``_pack_tree`` byte for byte, and reads back equal."""
    _, state, opt = run_ef(tiny_cfg, init_params, placement, n_steps=3, frags=3)
    sd = opt.state_dict()
    if placement == "host":
        assert any(r is None for r in sd["ef_residual"]) and any(r is not None for r in sd["ef_residual"])
    d = tckpt.save_checkpoint(str(tmp_path), 3, state, diloco_rank=0, diloco_state=sd)
    jmeta, jblob = jckpt._pack_tree(sd)
    with open(f"{d}/diloco_state.bin", "rb") as f:
        assert f.read() == bytes(jblob)
    with open(f"{d}/diloco_state.json") as f:
        assert json.load(f) == json.loads(json.dumps(jmeta))
    _, back, _, _ = tckpt.load_checkpoint(d, port_trainer(tiny_cfg).init_state(params=init_params))
    assert_same_state(sd, back)
