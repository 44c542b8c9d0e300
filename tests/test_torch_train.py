"""Parity of the port's training slice with the JAX package, on the CPU.

Parameters and batches are drawn with numpy (or taken from the JAX
package's own init) and handed to both packages; JAX runs on one CPU
device, Pallas kernels in interpret mode, and the port on the CPU, where
the flash-attention wrappers take their plain versions. All in f32.

Tolerances, each for the same reason: both sides compute in f32 and
differ only in the order of their sums (XLA's fused reductions against
PyTorch's), so
- logits and losses: atol 2e-5 (values of magnitude <= ~10);
- a 5-step AdamW trajectory: loss and grad norm rtol 1e-5, params atol
  1e-6 (updates are lr-sized, 1e-3, and Adam's m / sqrt(v) carries the
  relative f32 error of the gradients, ~1e-6 of an update);
- the DiLoCo master after two outer rounds: atol 1e-5 (the outer step
  multiplies pseudo-gradient differences by lr 0.7 and momentum).
"""
import os
import pickle
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opendiloco_tpu.models import llama as jllama
from opendiloco_tpu.parallel.mesh import build_mesh
from opendiloco_tpu.trainer import InnerTrainer as JInnerTrainer
from opendiloco_tpu.trainer import TrainerConfig as JTrainerConfig
from opendiloco_tpu.trainer import make_schedule as j_make_schedule
from opendiloco_torch.config import Config, DilocoConfig
from opendiloco_torch.diloco import DiLoCoOptimizer, LoopbackWorld
from opendiloco_torch.models import llama as tllama
from opendiloco_torch.models.convert import params_from_numpy, params_to_numpy
from opendiloco_torch.models.hf_io import load_config
from opendiloco_torch.ops.launch import LAUNCHES
from opendiloco_torch.train import train
from opendiloco_torch.trainer import InnerTrainer, TrainerConfig, make_schedule

torch.set_num_threads(2)


@pytest.fixture
def interpret_pallas(monkeypatch):
    """Run the JAX package's flash-attention kernels in interpreter mode."""
    import jax.experimental.pallas as pl

    from opendiloco_tpu.ops import flash_attention as fa

    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(fa.pl, "pallas_call", patched)


def _np_params(cfg, seed):
    """Weights in the shared layout, drawn with numpy: N(0, 0.02), norms
    near 1 (not exactly 1, so the norm weights matter)."""
    rng = np.random.default_rng(seed)

    def draw(tree, name=""):
        if isinstance(tree, dict):
            return {k: draw(v, k) for k, v in tree.items()}
        base, scale = (1.0, 0.1) if "norm" in name else (0.0, 0.02)
        return (base + scale * rng.standard_normal(tree)).astype(np.float32)

    return draw(tllama.shapes(cfg))


def _ramp_batch(rng, vocab, bs, seq):
    starts = rng.integers(0, vocab, (bs, 1))
    ids = ((starts + np.arange(seq)) % vocab).astype(np.int32)
    return ids, ids.copy()


def _one_device_mesh():
    return build_mesh("NO_SHARD", devices=[jax.devices()[0]])


def _config(name, tiny_cfg):
    return tiny_cfg if name == "tiny" else load_config(name)


# ---------------------------------------------------------------------------
# forward and loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("remat", [False, True], ids=["save", "remat"])
@pytest.mark.parametrize("attn_impl", ["xla", "pallas"])
@pytest.mark.parametrize("model", ["tiny", "2m"])
def test_forward_and_loss_match_jax(interpret_pallas, tiny_cfg, model, attn_impl, remat):
    cfg = _config(model, tiny_cfg)
    params = _np_params(cfg, 1)
    rng = np.random.default_rng(2)
    ids = rng.integers(0, cfg.vocab_size, (2, 128)).astype(np.int32)
    labels = ids.copy()
    labels[0, :5] = -100  # ignored targets count in neither sum nor mean
    jlogits, jaux = jllama.forward(params, jnp.asarray(ids), cfg, compute_dtype=jnp.float32,
                                   attn_impl=attn_impl, remat=remat, return_aux=True)
    jloss = jllama.causal_lm_loss(jlogits, jnp.asarray(labels))
    tparams = params_from_numpy(params)
    tlogits, taux = tllama.forward(tparams, torch.from_numpy(ids).long(), cfg,
                                   compute_dtype=torch.float32, attn_impl=attn_impl, remat=remat,
                                   return_aux=True)
    tloss = tllama.causal_lm_loss(tlogits, torch.from_numpy(labels).long())
    np.testing.assert_allclose(tlogits.detach().numpy(), np.asarray(jlogits), atol=2e-5, rtol=0)
    np.testing.assert_allclose(float(tloss), float(jloss), atol=2e-5, rtol=0)
    np.testing.assert_allclose(taux["attn_out_norm"].detach().numpy(), np.asarray(jaux["attn_out_norm"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(taux["lm_head_norm"]), float(jaux["lm_head_norm"]), rtol=1e-5)


def test_return_hidden_matches_jax(tiny_cfg):
    params = _np_params(tiny_cfg, 3)
    ids = np.random.default_rng(4).integers(0, tiny_cfg.vocab_size, (2, 32)).astype(np.int32)
    jh, jhead = jllama.forward(params, jnp.asarray(ids), tiny_cfg, compute_dtype=jnp.float32,
                               return_hidden=True)
    th, thead = tllama.forward(params_from_numpy(params), torch.from_numpy(ids).long(), tiny_cfg,
                               compute_dtype=torch.float32, return_hidden=True)
    np.testing.assert_allclose(th.detach().numpy(), np.asarray(jh), atol=2e-5, rtol=0)
    np.testing.assert_array_equal(thead.detach().numpy(), np.asarray(jhead))


def test_flatten_order_is_jax_tree_order(tiny_cfg):
    params = _np_params(tiny_cfg, 5)
    jleaves = jax.tree.leaves(params)
    tleaves = tllama.flatten_params(params_from_numpy(params))
    assert len(jleaves) == len(tleaves)
    for a, b in zip(jleaves, tleaves):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    rebuilt = tllama.unflatten_params(params, tleaves)
    assert jax.tree.structure(params_to_numpy(rebuilt)) == jax.tree.structure(params)


# ---------------------------------------------------------------------------
# schedule and inner trainer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("warmup,total", [(2, 200), (1000, 88_000), (5, 12)])
def test_schedule_matches_optax(warmup, total):
    j = j_make_schedule(JTrainerConfig(lr=4e-4, warmup_steps=warmup, total_steps=total))
    t = make_schedule(TrainerConfig(lr=4e-4, warmup_steps=warmup, total_steps=total))
    assert t(0) == 0.0  # optax's linear warmup starts at lr 0
    for step in (0, 1, warmup - 1, warmup, warmup + 1, (warmup + total) // 2, total, total + 3):
        assert t(step) == pytest.approx(float(j(step)), rel=1e-6, abs=1e-12), step


def _trajectories(tiny_cfg, n_steps=5, accum=2, **kw):
    tc_kw = dict(lr=1e-3, warmup_steps=2, total_steps=20, precision="fp32", remat=False,
                 attn_impl="xla", max_grad_norm=0.05, **kw)
    params = _np_params(tiny_cfg, 6)
    jt = JInnerTrainer(tiny_cfg, JTrainerConfig(**tc_kw), _one_device_mesh())
    tt = InnerTrainer(tiny_cfg, TrainerConfig(**tc_kw), device="cpu")
    jstate = jt.init_state(jax.random.key(0), params)
    tstate = tt.init_state(params=params)
    rng = np.random.default_rng(7)
    rows = []
    for _ in range(n_steps):
        ids, labels = _ramp_batch(rng, tiny_cfg.vocab_size, 8, 32)
        jstate, jm = jt.train_step(jstate, jt.shard_batch(ids, labels, accum=accum))
        tstate, tm = tt.train_step(tstate, tt.shard_batch(ids, labels, accum=accum))
        rows.append((float(jm["loss"]), float(tm["loss"]), float(jm["grad_norm"]), float(tm["grad_norm"])))
    return rows, jax.device_get(jstate), tstate


def test_inner_trainer_trajectory_matches_jax(tiny_cfg):
    """5 steps, accum 2, a clip that bites at every step, warmup from lr 0:
    loss, grad norm and the params after the last step."""
    rows, jstate, tstate = _trajectories(tiny_cfg)
    rows = np.array(rows)
    assert (rows[:, 2] > 0.05).all(), "the clip must bite"
    np.testing.assert_allclose(rows[:, 1], rows[:, 0], rtol=1e-5)
    np.testing.assert_allclose(rows[:, 3], rows[:, 2], rtol=1e-5)
    assert tstate["step"] == int(jstate["step"]) == 5
    tparams = params_to_numpy(tstate["params"])
    for a, b in zip(jax.tree.leaves(jstate["params"]), tllama.flatten_params(tparams)):
        np.testing.assert_allclose(b, np.asarray(a), atol=1e-6, rtol=0)
    # the Adam moments line up leaf for leaf with optax's
    jadam = jstate["opt_state"][1][0]
    assert tstate["opt_state"]["count"] == int(jadam.count) == 5
    for a, b in zip(jax.tree.leaves(jadam.mu), tstate["opt_state"]["mu"]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-7, rtol=1e-4)


def test_update_in_leaf_groups_is_bitwise_the_same(tiny_cfg):
    """The AdamW update walks the leaves one at a time (to bound its
    temporaries at 1b); that gives the same bits as one update over the
    whole list of leaves."""
    import opendiloco_torch.trainer as ttrainer

    tc = TrainerConfig(lr=1e-3, warmup_steps=1, total_steps=20, max_grad_norm=0.5)
    rng = np.random.default_rng(6)
    params = tllama.flatten_params(params_from_numpy(_np_params(tiny_cfg, 6)))
    grads = [torch.from_numpy(rng.normal(size=tuple(p.shape)).astype(np.float32)) for p in params]
    norm = ttrainer.global_norm(grads)
    assert float(norm) > tc.max_grad_norm  # the clip is taken
    opt = ttrainer.InnerOptimizer(tc)
    state, p_leaf = opt.init(params), [p.clone() for p in params]
    for _ in range(2):
        opt.update(grads, state, p_leaf, norm)
    p_all = [p.clone() for p in params]
    mu, nu = [torch.zeros_like(p) for p in params], [torch.zeros_like(p) for p in params]
    for count in (1, 2):
        bc1, bc2 = (float(np.float32(1) - np.float32(b) ** np.float32(count)) for b in tc.adam_betas)
        ttrainer._adamw_leaves(tc, grads, mu, nu, p_all, norm, bc1, bc2, opt.schedule(count - 1))
    for a, b in zip(p_leaf + state["mu"] + state["nu"], p_all + mu + nu):
        assert torch.equal(a, b)


def test_inner_trainer_pallas_attention_matches_jax(interpret_pallas, tiny_cfg):
    """The same trajectory through the flash-attention path on both sides
    (Pallas interpret there, the plain versions of B1/B2 here), remat on."""
    tc_kw = dict(lr=1e-3, warmup_steps=1, total_steps=20, precision="fp32", remat=True,
                 attn_impl="pallas", max_grad_norm=1.0)
    params = _np_params(tiny_cfg, 8)
    jt = JInnerTrainer(tiny_cfg, JTrainerConfig(**tc_kw), _one_device_mesh())
    tt = InnerTrainer(tiny_cfg, TrainerConfig(**tc_kw), device="cpu")
    assert tt.tc.attn_impl == "pallas"
    jstate, tstate = jt.init_state(jax.random.key(0), params), tt.init_state(params=params)
    rng = np.random.default_rng(9)
    for _ in range(2):
        ids, labels = _ramp_batch(rng, tiny_cfg.vocab_size, 4, 128)
        jstate, jm = jt.train_step(jstate, jt.shard_batch(ids, labels, accum=1))
        tstate, tm = tt.train_step(tstate, tt.shard_batch(ids, labels, accum=1))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)


def test_fp16_overflow_skips_step_and_halves_scale(tiny_cfg):
    tc = TrainerConfig(lr=1e-3, warmup_steps=2, total_steps=100, precision="fp16-mixed",
                       remat=False, init_loss_scale=1e38)
    trainer = InnerTrainer(tiny_cfg, tc, device="cpu")
    state = trainer.init_state(params=_np_params(tiny_cfg, 10))
    before = state["params"]["final_norm"].detach().clone()
    mu_before = [m.clone() for m in state["opt_state"]["mu"]]
    ids, labels = _ramp_batch(np.random.default_rng(0), tiny_cfg.vocab_size, 8, 16)
    state, m = trainer.train_step(state, trainer.shard_batch(ids, labels, accum=1))
    assert float(m["found_inf"]) == 1.0 and float(m["loss_scale"]) == pytest.approx(1e38)
    assert torch.equal(state["params"]["final_norm"], before)  # update skipped
    assert all(torch.equal(a, b) for a, b in zip(state["opt_state"]["mu"], mu_before))
    assert state["opt_state"]["count"] == 0 and state["step"] == 1
    assert state["scaler"]["scale"] == pytest.approx(0.5e38)
    assert state["scaler"]["good_steps"] == 0


def test_fp16_loss_scaling_trains_and_grows(tiny_cfg):
    tc = TrainerConfig(lr=1e-3, warmup_steps=2, total_steps=100, precision="fp16-mixed",
                       remat=False, init_loss_scale=2.0**10, scale_growth_interval=4)
    trainer = InnerTrainer(tiny_cfg, tc, device="cpu")
    state = trainer.init_state(params=_np_params(tiny_cfg, 11))
    rng = np.random.default_rng(0)
    losses, scales = [], []
    for _ in range(6):
        ids, labels = _ramp_batch(rng, tiny_cfg.vocab_size, 8, 16)
        state, m = trainer.train_step(state, trainer.shard_batch(ids, labels, accum=1))
        assert float(m["found_inf"]) == 0.0
        losses.append(float(m["loss"]))
        scales.append(float(m["loss_scale"]))
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert scales[-1] == 2.0**11  # grew once after 4 clean steps


def test_force_step_position_rewrites_every_count(tiny_cfg):
    trainer = InnerTrainer(tiny_cfg, TrainerConfig(warmup_steps=3, total_steps=50, precision="fp32"),
                           device="cpu")
    state = trainer.force_step_position(trainer.init_state(0), 12)
    assert state["step"] == 12
    assert state["opt_state"]["count"] == state["opt_state"]["schedule_count"] == 12
    assert trainer.current_lr(12) == make_schedule(trainer.tc)(12)


def test_eval_loss_and_probe_norms_match_jax(tiny_cfg):
    params = _np_params(tiny_cfg, 12)
    tc_kw = dict(precision="fp32", attn_impl="xla", remat=False)
    jt = JInnerTrainer(tiny_cfg, JTrainerConfig(**tc_kw), _one_device_mesh())
    tt = InnerTrainer(tiny_cfg, TrainerConfig(**tc_kw), device="cpu")
    jstate, tstate = jt.init_state(jax.random.key(0), params), tt.init_state(params=params)
    ids, labels = _ramp_batch(np.random.default_rng(1), tiny_cfg.vocab_size, 4, 32)
    assert tt.eval_loss(tstate["params"], ids, labels) == pytest.approx(
        jt.eval_loss(jstate["params"], ids, labels), abs=2e-5)
    jp, tp = jt.probe_norms(jstate["params"], ids), tt.probe_norms(tstate["params"], ids)
    assert jp.keys() == tp.keys()
    for k in jp:
        assert tp[k] == pytest.approx(jp[k], rel=1e-5)


# ---------------------------------------------------------------------------
# DiLoCo on the loopback backend
# ---------------------------------------------------------------------------


def _torch_diloco_workers(tiny_cfg, params, n_workers, n_steps, local_steps):
    """The port's side of tests/test_diloco.py run_diloco_workers: the same
    trainer settings, data and outer config, one thread per worker."""
    from test_diloco import batches

    world = LoopbackWorld(n_workers)
    backends = world.make_backends()
    results, errors, masters = [None] * n_workers, [], [[] for _ in range(n_workers)]

    def worker(rank):
        try:
            tc = TrainerConfig(lr=1e-3, warmup_steps=2, total_steps=200, precision="fp32", remat=False)
            trainer = InnerTrainer(tiny_cfg, tc, device="cpu")
            state = trainer.init_state(params=params)
            cfg = DilocoConfig(local_steps=local_steps, outer_nesterov=True, backend="loopback",
                               timeout_waiting_for_peers=30.0, averaging_timeout=60.0)
            opt = DiLoCoOptimizer(trainer, backends[rank], cfg, state, batch_size=8)
            losses = []
            for ids, labels in batches(1000 + rank, tiny_cfg.vocab_size, n_steps):
                state, m = opt.step(state, trainer.shard_batch(ids, labels, accum=1))
                losses.append(float(m["loss"]))
                if "outer_step_s" in m:
                    masters[rank].append([x.copy() for x in opt.master])
            results[rank] = (np.array(losses), params_to_numpy(state["params"]))
        except Exception as e:  # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(r,)) for r in range(n_workers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors, errors
    return results, masters


def test_two_worker_diloco_matches_jax_loopback(tiny_cfg):
    """Two loopback workers, 8 steps, local_steps 4 (two outer rounds),
    against the JAX package's run_diloco_workers from the same init."""
    from test_diloco import make_trainer, run_diloco_workers

    params = jax.device_get(make_trainer(tiny_cfg).init_state(jax.random.key(7))["params"])
    jres = run_diloco_workers(tiny_cfg, 2, 8, 4)
    tres, masters = _torch_diloco_workers(tiny_cfg, params, 2, 8, 4)
    for (jl, jp), (tl, tp) in zip(jres, tres):
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
        for a, b in zip(jax.tree.leaves(jp), tllama.flatten_params(tp)):
            np.testing.assert_allclose(b, np.asarray(a), atol=1e-5, rtol=0)
    # every round leaves both workers with the same master, bit for bit
    assert len(masters[0]) == len(masters[1]) == 2
    for m0, m1 in zip(*masters):
        assert all(np.array_equal(a, b) for a, b in zip(m0, m1))


def test_outer_sgd_matches_jax_outer_sgd():
    from opendiloco_tpu.diloco.outer_optimizer import OuterSGD as JOuterSGD

    from opendiloco_torch.diloco import OuterSGD

    rng = np.random.default_rng(0)
    shapes = [(5, 3), (7,), (2, 2, 2)]
    jp = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    tp = [p.copy() for p in jp]
    jo, to = JOuterSGD(), OuterSGD()
    for _ in range(4):
        g = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        jo.step(jp, [x.copy() for x in g])
        to.step(tp, [x.copy() for x in g])
    for a, b in zip(jp, tp):
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-7)
    sd = to.state_dict()
    clone = OuterSGD(lr=0.1)
    clone.load_state_dict(sd)
    assert clone.lr == to.lr and all(np.array_equal(a, b) for a, b in zip(clone.bufs, to.bufs))


def test_diloco_state_dict_round_trips(tiny_cfg):
    (backend,) = LoopbackWorld(1).make_backends()
    trainer = InnerTrainer(tiny_cfg, TrainerConfig(precision="fp32", warmup_steps=1, total_steps=10),
                           device="cpu")
    state = trainer.init_state(3)
    opt = DiLoCoOptimizer(trainer, backend, DilocoConfig(local_steps=2, backend="loopback"), state, 4)
    ids, labels = _ramp_batch(np.random.default_rng(0), tiny_cfg.vocab_size, 4, 16)
    for _ in range(3):
        state, _ = opt.step(state, trainer.shard_batch(ids, labels, accum=1))
    sd = opt.state_dict()
    assert (sd["epoch"], sd["local_step"], sd["samples_in_epoch"]) == (1, 1, 4)
    other = DiLoCoOptimizer(trainer, backend, DilocoConfig(local_steps=2, backend="loopback"), state, 4)
    other.load_state_dict(sd)
    assert other.epoch == 1 and other.local_step == 1
    assert all(np.array_equal(a, b) for a, b in zip(other.master, opt.master))


# ---------------------------------------------------------------------------
# train()
# ---------------------------------------------------------------------------


def _train_config(tmp_path, rank, **kw):
    base = dict(path_model="2m", fake_data=True, fake_data_mode="ramp", seq_length=64,
                per_device_train_batch_size=4, total_batch_size=8, warmup_steps=2, total_steps=12,
                lr=3e-3, metric_logger_type="dummy", project=str(tmp_path / f"metrics-{rank}.pkl"),
                precision="fp32",
                diloco=dict(local_steps=4, backend="loopback", world_rank=rank,
                            timeout_waiting_for_peers=30.0))
    base.update(kw)
    return Config(**base)


def test_train_two_loopback_workers_on_ramp_data(tmp_path):
    """train() in two threads over one loopback world: the loss falls, the
    rows carry the outer rounds, and the CPU never launches a kernel."""
    world = LoopbackWorld(2)
    backends = world.make_backends()
    summaries, errors = [None, None], []
    before = dict(LAUNCHES)

    def run(rank):
        try:
            summaries[rank] = train(_train_config(tmp_path, rank, attn_implementation="pallas"),
                                    backends[rank], device="cpu")
        except Exception as e:  # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=run, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors, errors
    assert LAUNCHES == before
    for rank in range(2):
        assert summaries[rank]["step"] == 12
        with open(tmp_path / f"metrics-{rank}.pkl", "rb") as f:
            rows = pickle.load(f)
        losses = [r["Loss"] for r in rows]
        assert len(rows) == 12 and np.isfinite(losses).all()
        assert losses[-1] < losses[0] - 0.5  # ramps are learnable
        assert [r["outer_epoch"] for r in rows if "outer_step_s" in r] == [1, 2, 3]
        assert all(r["num_peers"] == 2 for r in rows[4:])
        assert rows[0]["lr"] == pytest.approx(make_schedule(TrainerConfig(lr=3e-3, warmup_steps=2,
                                                                          total_steps=12))(1))


def test_fake_data_matches_the_jax_loader():
    """The port's fake stream is numpy-only, so it yields the JAX loader's
    batches bit for bit (the parity tests rely on that)."""
    from opendiloco_tpu.data.dataloader import get_dataloader as j_get_dataloader

    from opendiloco_torch.data.dataloader import get_dataloader

    kw = dict(fake_data=True, fake_data_mode="ramp", dataset_name_or_paths="", tokenizer_name="",
              seq_length=32, batch_size=4, vocab_size=1000, world_rank=1)
    jl, tl = j_get_dataloader(**kw), get_dataloader(**kw)
    try:
        for jb, tb in zip(iter(jl), iter(tl)):
            np.testing.assert_array_equal(tb["input_ids"], jb["input_ids"])
            np.testing.assert_array_equal(tb["labels"], jb["labels"])
            if tl.state_dict()["dataset"]["samples_seen"] >= 12:
                break
    finally:
        jl.stop()
        tl.stop()
    assert tl.state_dict() == {"dataset": {"samples_seen": 12, "seed": 43}}


def test_train_without_diloco_with_eval_and_probes(tmp_path):
    summary = train(_train_config(tmp_path, 0, diloco=None, total_steps=4, eval_interval=2,
                                  eval_batches=2, log_activations_steps=2), device="cpu")
    assert summary["step"] == 4 and np.isfinite(summary["loss"])
    with open(tmp_path / "metrics-0.pkl", "rb") as f:
        rows = pickle.load(f)
    assert "eval_loss" in rows[1] and "activation_norm/lm_head" in rows[3]


# ---------------------------------------------------------------------------
# options that are not ported raise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "overrides",
    [
        dict(attn_implementation="ring"),
        dict(fleet=dict(replicas=2)),
        dict(remat="dots"),
        dict(remat="dots_all"),
        dict(ckpt=dict(interval=5)),
        dict(ckpt=dict(resume=True)),
        dict(serve=dict(enabled=True)),
        dict(multihost=True),
        dict(profile_dir="trace"),
        dict(sharding_strategy="FULL_SHARD"),
        dict(pp_size=2),
        dict(fake_data=False),
        dict(metric_logger_type="wandb"),
        dict(metric_logger_type="jsonl"),
        dict(path_model="2m_4e"),
        dict(diloco=dict(backend="tcp")),
        dict(diloco=dict(backend="loopback", outer_placement="device")),
        dict(diloco=dict(backend="loopback", overlap_comm="eager")),
        dict(diloco=dict(backend="loopback", streaming_fragments=2)),
        dict(diloco=dict(backend="loopback", outer_mode="gossip")),
        dict(diloco=dict(backend="loopback", compression="fp16")),
        dict(diloco=dict(backend="loopback", compression="fp16", error_feedback=True)),
        dict(diloco=dict(backend="loopback", average_state_every=2)),
    ],
    ids=lambda o: "-".join(f"{k}={v}" for k, v in o.items()),
)
def test_unported_options_raise(tmp_path, overrides):
    # a tcp config gets no backend from the caller, so train() asks make_backend
    tcp = overrides.get("diloco", {}).get("backend") == "tcp"
    backend = None if tcp else LoopbackWorld(1).make_backends()[0]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        train(_train_config(tmp_path, 0, **overrides), backend, device="cpu")


@pytest.mark.parametrize(
    "section,field,value",
    [
        ("config", "prefetch_depth", 0),
        ("config", "num_workers", 4),
        ("config", "profile_steps", 5),
        ("config", "coordinator_address", "localhost:1234"),
        ("diloco", "link_adapt", True),
        ("diloco", "initial_peers", "localhost:1234"),
        ("diloco", "stream_stagger", 0.5),
        ("ckpt", "path", "outputs"),
    ],
)
def test_fields_the_port_does_not_read_are_refused(section, field, value):
    # a JAX config that sets an option train() would not honour fails at
    # construction instead of being ignored
    with pytest.raises(TypeError, match=field):
        if section == "config":
            Config(**{field: value})
        else:
            Config(**{section: {field: value}})


def test_log_lines_carry_each_threads_rank():
    import io

    from opendiloco_torch.utils.logger import get_text_logger, log_rank

    logger = get_text_logger("opendiloco_torch.test_rank")
    out = io.StringIO()
    logger.handlers[0].setStream(out)

    def worker(rank):
        with log_rank(rank):
            logger.warning("worker %d", rank)

    threads = [threading.Thread(target=worker, args=(r,)) for r in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    lines = sorted(out.getvalue().splitlines())
    assert len(lines) == 2
    for rank, line in enumerate(lines):
        assert line.startswith(f"[rank {rank}] ") and line.endswith(f"worker {rank}")


def test_unported_codec_and_fp16_kernels_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        LoopbackWorld(2, compression="blockwise4bit")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tllama.forward({}, torch.zeros(1, 4, dtype=torch.long), tllama.LlamaConfig(), pp_mesh=object())


def test_entry_points_default_to_the_card(tiny_cfg):
    if torch.cuda.is_available():
        pytest.skip("this checks the default device where there is no card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InnerTrainer(tiny_cfg, TrainerConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(Config(path_model="2m", fake_data=True, metric_logger_type="dummy",
                      project=os.devnull))
