"""The routed-expert (Switch top-1) FFN and expert parallelism of the
port against the JAX package, on the CPU.

Weights and batches are numpy draws handed to both packages; everything
runs in f32. Tolerances, each with its reason:

- the FFN alone (outputs, aux, gradients): atol 2e-6 and rtol 1e-5 (a
  few ulp of values up to ~1). Both sides compute the same f32 products
  and differ only in the order of their sums; dispatch and combine are
  exact (one nonzero a token).
- a trainer trajectory (3 steps, accum 2): loss and grad norm rtol 1e-5,
  params atol 1e-5, as ``tests/test_torch_parallel.py`` holds the sharded
  strategies: ranks and frameworks re-associate the f32 gradient sums,
  and AdamW carries their relative error into lr-sized updates.

The capacity factor 0.5 drops tokens at every layer (the tests check the
count), so a rank that assigned slots from its own tokens' order, or took
the load-balance means over its own tokens, would route and drop other
tokens than the JAX package's global order does.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opendiloco_tpu.models import llama as jllama
from opendiloco_tpu.parallel.mesh import build_mesh as jbuild_mesh
from opendiloco_tpu.trainer import InnerTrainer as JInnerTrainer
from opendiloco_tpu.trainer import TrainerConfig as JTrainerConfig
from opendiloco_torch.config import DilocoConfig
from opendiloco_torch.diloco import DiLoCoOptimizer, LoopbackWorld
from opendiloco_torch.models import llama as tllama
from opendiloco_torch.models.convert import params_from_numpy, params_to_numpy
from opendiloco_torch.models.hf_io import load_config
from opendiloco_torch.trainer import InnerTrainer, TrainerConfig
from torch_dist_child import spawn

torch.set_num_threads(2)

CFG = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
           num_key_value_heads=2, max_position_embeddings=128, num_experts=4, expert_capacity_factor=0.5)
TC = dict(lr=1e-3, warmup_steps=2, total_steps=100, precision="fp32", remat=False)
DILOCO = dict(local_steps=2, backend="loopback")
# name: (strategy, mesh kwargs, world); attn_impl "auto": plain attention,
# the ring under sp, in both packages
DIST = {
    "ep2": ("NO_SHARD", {"ep_size": 2}, 2),
    "ep4": ("NO_SHARD", {"ep_size": 4}, 4),
    "dp2_ep2": ("NO_SHARD", {"ep_size": 2}, 4),
    "fsdp2_ep2": ("FULL_SHARD", {"ep_size": 2}, 4),
    "sp2_ep2": ("NO_SHARD", {"ep_size": 2, "sp_size": 2}, 4),
}


def _np_params(cfg, seed):
    rng = np.random.default_rng(seed)

    def draw(tree, name=""):
        if isinstance(tree, dict):
            return {k: draw(v, k) for k, v in tree.items()}
        base, scale = (1.0, 0.1) if "norm" in name else (0.0, 0.05)
        return (base + scale * rng.standard_normal(tree)).astype(np.float32)

    return draw(tllama.shapes(cfg))


def _batches(vocab: int, n: int = 3, bs: int = 8, seq: int = 32):
    rng = np.random.default_rng(11)
    out = []
    for _ in range(n):
        ids = rng.integers(0, vocab, (bs, seq)).astype(np.int32)
        out.append((ids, ids.copy()))
    return out


# ---------------------------------------------------------------------------
# the FFN
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cf", [4.0, 0.5], ids=["roomy", "drops"])
def test_switch_ffn_matches_jax(cf):
    """Outputs, aux and the gradients of sum(y * w) + aux in x and every
    FFN leaf; at capacity factor 0.5 tokens are dropped (and pass through
    as zeros), at 4.0 none."""
    cfg = tllama.LlamaConfig(**{**CFG, "expert_capacity_factor": cf})
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 24, 64)).astype(np.float32)
    w = rng.standard_normal((2, 24, 64)).astype(np.float32)
    shapes = tllama.shapes(cfg)["layers"]
    layer = {k: (0.1 * rng.standard_normal(shapes[k][1:])).astype(np.float32)
             for k in ("router", "gate_proj", "up_proj", "down_proj")}

    def jloss(x, layer):
        y, aux = jllama._switch_ffn(cfg, x, layer)
        return jnp.sum(y * w) + aux, (y, aux)

    (_, (jy, jaux)), jgrads = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in layer.items()})
    tx = torch.from_numpy(x).requires_grad_(True)
    tlayer = {k: torch.from_numpy(v).requires_grad_(True) for k, v in layer.items()}
    stats: list = []
    ty, taux = tllama._switch_ffn(cfg, tx, tlayer, stats=stats)
    (torch.sum(ty * torch.from_numpy(w)) + taux).backward()
    dropped = int(stats[0])
    assert (dropped > 0) == (cf < 1), dropped
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), atol=2e-6, rtol=0)
    np.testing.assert_allclose(float(taux.detach()), float(jaux), atol=2e-6, rtol=0)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgrads[0]), atol=2e-6, rtol=1e-5)
    for k in layer:
        np.testing.assert_allclose(tlayer[k].grad.numpy(), np.asarray(jgrads[1][k]), atol=2e-6, rtol=1e-5,
                                   err_msg=k)


def test_single_expert_equals_dense():
    """E=1 with capacity for every token: the MoE forward is the dense
    forward with the same weights, and the aux is E * 1 * 1."""
    dense_cfg = tllama.LlamaConfig(**{**CFG, "num_experts": 0})
    moe_cfg = tllama.LlamaConfig(**{**CFG, "num_experts": 1, "expert_capacity_factor": 2.0})
    dense = _np_params(dense_cfg, 0)
    moe = _np_params(moe_cfg, 1)
    for k in ("gate_proj", "up_proj", "down_proj"):
        moe["layers"][k] = dense["layers"][k][:, None]
    for k in ("input_norm", "post_attn_norm", "q_proj", "k_proj", "v_proj", "o_proj"):
        moe["layers"][k] = dense["layers"][k]
    for k in ("embed_tokens", "final_norm", "lm_head"):
        moe[k] = dense[k]
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 32)))
    ref = tllama.forward(params_from_numpy(dense), ids, dense_cfg, compute_dtype=torch.float32, remat=False)
    got, aux = tllama.forward(params_from_numpy(moe), ids, moe_cfg, compute_dtype=torch.float32, remat=False,
                              return_moe_aux=True)
    np.testing.assert_allclose(got.detach().numpy(), ref.detach().numpy(), atol=2e-5, rtol=0)
    np.testing.assert_allclose(float(aux), 1.0, atol=1e-6)


# ---------------------------------------------------------------------------
# the trainer, one device
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fused", [False, True], ids=["standard", "fused"])
def test_inner_trainer_2m_4e_matches_jax(interpret_pallas_fused, fused):
    """config_2m_4e, 3 steps at accum 2 with the router aux in the loss,
    through the standard and the fused loss (the JAX fused loss with its
    kernels in interpret mode): losses, grad norms and the params."""
    cfg = load_config("2m_4e")
    tc = dict(TC, attn_impl="xla", fused_loss=fused, remat=True)
    params = _np_params(cfg, 4)
    jt = JInnerTrainer(cfg, JTrainerConfig(**tc), jbuild_mesh("NO_SHARD", devices=[jax.devices()[0]]))
    tt = InnerTrainer(cfg, TrainerConfig(**tc), device="cpu")
    assert tt.tc.fused_loss is fused
    jstate, tstate = jt.init_state(jax.random.key(0), params), tt.init_state(params=params)
    for ids, labels in _batches(cfg.vocab_size, bs=4, seq=64):
        jstate, jm = jt.train_step(jstate, jt.shard_batch(ids, labels, accum=2))
        tstate, tm = tt.train_step(tstate, tt.shard_batch(ids, labels, accum=2))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
    jleaves = jax.tree.leaves(jax.device_get(jstate["params"]))
    for a, b in zip(jleaves, tllama.flatten_params(params_to_numpy(tstate["params"]))):
        np.testing.assert_allclose(b, np.asarray(a), atol=1e-5, rtol=0)


def test_moe_probe_and_eval_run():
    """The probes and the eval loss of an MoE trainer (the aux is not a
    probe of the port's, as it is not in the JAX package's rows)."""
    cfg = tllama.LlamaConfig(**CFG)
    trainer = InnerTrainer(cfg, TrainerConfig(**TC), device="cpu")
    state = trainer.init_state(params=_np_params(cfg, 2))
    ids, labels = _batches(cfg.vocab_size, n=1)[0]
    probes = trainer.probe_norms(state["params"], ids)
    assert sorted(probes) == ["activation_norm/layers.0.self_attn", "activation_norm/layers.1.self_attn",
                              "activation_norm/lm_head"]
    assert np.isfinite(trainer.eval_loss(state["params"], ids, labels))


# ---------------------------------------------------------------------------
# ep (and dp, fsdp, sp beside it) over gloo ranks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each case of DIST over its gloo ranks (one launch a world size), the
    single-device port in this process, and the JAX trainer on as many
    virtual devices, on the same params and batches."""
    cfg = tllama.LlamaConfig(**CFG)
    params = _np_params(cfg, 6)
    batches = _batches(cfg.vocab_size)
    ev = batches[0]
    spec = dict(cfg=CFG, params=params, batches=batches, eval=ev, tc=dict(TC, attn_impl="auto"), accum=2)
    tmp = tmp_path_factory.mktemp("moe")
    got, diloco = {}, None
    for world in sorted({w for *_, w in DIST.values()}):
        cases = {k: (s, kw) for k, (s, kw, w) in DIST.items() if w == world}
        jobs = [("strategies", {**spec, "cases": cases})]
        if world == 2:  # one DiLoCo worker of two ep ranks
            jobs.append(("diloco", dict(cfg=CFG, params=params, batches=batches, tc=TC, accum=2, batch_size=8,
                                        cases={"ep2": ("NO_SHARD", {"ep_size": 2}, DILOCO)})))
        ranks = spawn("many", world, {"jobs": jobs}, tmp)
        for case in cases:  # every rank reports the same trajectory
            assert all(r[0][case]["losses"] == ranks[0][0][case]["losses"] for r in ranks), case
        got.update(ranks[0][0])
        if world == 2:
            diloco = [r[1]["ep2"] for r in ranks]
    trainer = InnerTrainer(cfg, TrainerConfig(**TC), device="cpu")
    state = trainer.init_state(params=params)
    losses = []
    for ids, labels in batches:
        state, m = trainer.train_step(state, trainer.shard_batch(ids, labels, accum=2))
        losses.append(float(m["loss"]))
    single = {"losses": losses, "params": [p.detach().numpy() for p in tllama.flatten_params(state["params"])],
              "eval": trainer.eval_loss(state["params"], *ev)}
    trainer = InnerTrainer(cfg, TrainerConfig(**TC), device="cpu")
    state = trainer.init_state(params=params)
    opt = DiLoCoOptimizer(trainer, LoopbackWorld(1).make_backends()[0], DilocoConfig(**DILOCO), state, batch_size=8)
    masters = []
    for ids, labels in batches:
        state, _ = opt.step(state, trainer.shard_batch(ids, labels, accum=2))
        masters.append([x.copy() for x in opt.master])
    return {"ranks": got, "single": single, "cfg": cfg, "params": params, "batches": batches,
            "diloco": diloco, "diloco_single": masters}


def test_diloco_worker_of_two_ep_ranks_gives_the_single_process_masters(runs):
    """One DiLoCo worker of two ep ranks: the outer loop's whole leaves
    (the ep blocks joined) give the one-process worker's master after
    every step (atol 1e-5, the DiLoCo parity tolerance of
    ``tests/test_torch_sharded_train.py``), on both ranks bit for bit;
    only rank 0 holds the backend."""
    got, want = runs["diloco"], runs["diloco_single"]
    assert [r["has_backend"] for r in got] == [True, False]
    assert len(got[0]["masters"]) == len(want) == len(runs["batches"])
    for step, (a, b) in enumerate(zip(got[0]["masters"], want)):
        for x, y in zip(a, b):
            np.testing.assert_allclose(x, y, atol=1e-5, rtol=0, err_msg=f"step {step}")
    assert all(np.array_equal(x, y) for x, y in zip(got[0]["final"], got[1]["final"]))


def _jax_run(cfg, strategy, kw, world, params, batches):
    jt = JInnerTrainer(cfg, JTrainerConfig(**TC), jbuild_mesh(strategy, devices=jax.devices()[:world], **kw))
    state = jt.init_state(jax.random.key(0), params)
    losses = []
    for ids, labels in batches:
        state, m = jt.train_step(state, jt.shard_batch(ids, labels, accum=2))
        losses.append(float(m["loss"]))
    return np.array(losses), [np.asarray(x) for x in jax.tree.leaves(jax.device_get(state["params"]))]


def test_capacity_drops_tokens_in_the_runs(runs):
    """The runs below are under capacity pressure: tokens are dropped."""
    cfg, params = runs["cfg"], runs["params"]
    stats: list = []
    ids = torch.from_numpy(runs["batches"][0][0][:4])
    tllama.forward(params_from_numpy(params), ids, cfg, compute_dtype=torch.float32, remat=False, moe_stats=stats)
    assert len(stats) == cfg.num_hidden_layers and all(int(s) > 0 for s in stats)


@pytest.mark.parametrize("case", list(DIST))
def test_expert_parallel_ranks_match_one_rank_and_jax(runs, case):
    """Every case's trajectory equals the single-device port's (the
    global slots, aux means and ep sums give the one-device result) and
    the JAX trainer's on as many virtual devices; the whole params that
    ``gather_state`` hands a checkpoint too, and the eval loss."""
    got, single = runs["ranks"][case], runs["single"]
    np.testing.assert_allclose(got["losses"], single["losses"], rtol=1e-5)
    for a, b in zip(got["params"], single["params"]):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
    assert got["eval"] == pytest.approx(single["eval"], rel=1e-5)
    strategy, kw, world = DIST[case]
    jlosses, jparams = _jax_run(runs["cfg"], strategy, kw, world, runs["params"], runs["batches"])
    np.testing.assert_allclose(got["losses"], jlosses, rtol=1e-5)
    for a, b in zip(got["params"], jparams):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)


def test_expert_leaves_are_cut_over_ep(runs):
    """A rank holds E/ep experts of each expert leaf, and under FULL_SHARD
    half of that block's D; the router is never cut over ep (FULL_SHARD
    halves its D)."""
    cfg = runs["cfg"]
    full = tllama.shapes(cfg)["layers"]
    for case, (strategy, kw, _) in DIST.items():
        shapes = tllama.unflatten_params(tllama.shapes(cfg), runs["ranks"][case]["shapes"]["params"])["layers"]
        fsdp = 2 if strategy == "FULL_SHARD" else 1
        L, E, D, F = full["gate_proj"]
        assert shapes["gate_proj"] == (L, E // kw["ep_size"], D // fsdp, F), case
        assert shapes["router"] == (L, D // fsdp, E), case


@pytest.mark.parametrize("for_params", [True, False], ids=["params", "optstate"])
@pytest.mark.parametrize("strategy,kw", [("NO_SHARD", {"ep_size": 4}), ("FULL_SHARD", {"ep_size": 2}),
                                         ("SHARD_GRAD_OP", {"ep_size": 2}), ("HYBRID_SHARD", {"ep_size": 2,
                                                                                           "fsdp_size": 2})])
def test_expert_param_specs_match_jax(strategy, kw, for_params):
    """The specs of every MoE leaf on four devices, ep and fsdp, are the
    JAX package's."""
    from opendiloco_tpu.parallel.sharding import param_specs as jparam_specs
    from opendiloco_torch.parallel.mesh import layout_plan
    from opendiloco_torch.parallel.sharding import param_specs

    cfg = tllama.LlamaConfig(**CFG)
    got = tllama.flatten_params(param_specs(cfg, layout_plan(strategy, 4, **kw), for_params=for_params))
    jspecs = jparam_specs(cfg, jbuild_mesh(strategy, devices=jax.devices()[:4], **kw), for_params=for_params)
    want = [tuple(p) for p in jax.tree.leaves(jspecs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))]
    assert got == want


def test_ep_with_a_dense_model_or_uneven_experts_raises():
    from opendiloco_torch.parallel.mesh import layout_plan

    dense = tllama.LlamaConfig(**{**CFG, "num_experts": 0})
    with pytest.raises(ValueError, match="dense model"):
        InnerTrainer(dense, TrainerConfig(**TC), device="cpu", plan=layout_plan("NO_SHARD", 2, ep_size=2))
    three = dataclasses.replace(tllama.LlamaConfig(**CFG), num_experts=3)
    with pytest.raises(ValueError, match="cannot shard over ep=2"):
        InnerTrainer(three, TrainerConfig(**TC), device="cpu", plan=layout_plan("NO_SHARD", 2, ep_size=2))


# ---------------------------------------------------------------------------
# the command line: two processes, a checkpoint and a resume
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("axis,model", [("ep", "2m_4e"), ("sp", "2m")])
def test_cli_checkpoint_of_ep_or_sp_holds_whole_leaves_and_resumes(tmp_path, axis, model):
    """``python -m opendiloco_torch.train --multihost`` over two processes
    with ep (or sp) 2 checkpoints at step 4 whole leaves (the shapes of
    ``llama.shapes``) and resumes from it bit for bit: steps 5-8's loss, lr
    and grad norm equal the run that did not stop."""
    import pickle

    from opendiloco_torch.utils import safetensors_io
    from test_torch_sharded_train import _launch

    args = ["--path-model", model, "--fake-data", "--fake-data-mode", "ramp", "--seq-length", "64",
            "--per-device-train-batch-size", "4", "--total-batch-size", "8", "--total-steps", "8",
            "--warmup-steps", "2", "--lr", "1e-3", "--precision", "fp32", "--metric-logger-type", "dummy",
            "--ckpt.interval", "4", f"--{axis}-size", "2"]

    def two(store: str, project: str, extra: list) -> list:
        return [[*args, "--multihost", "--coordinator-address", f"file://{tmp_path / store}", "--num-processes", "2",
                 "--process-id", str(i), "--project", str(tmp_path / project), *extra] for i in range(2)]

    _launch(two("s1", "full.pkl", ["--ckpt.path", str(tmp_path / "ckpts")]))
    step4 = tmp_path / "ckpts" / "model_step_4"
    _launch(two("s2", "resumed.pkl", ["--ckpt.path", str(tmp_path / "ckpts2"), "--ckpt.resume", str(step4)]))
    rows = {}
    for name in ("full", "resumed"):
        with open(tmp_path / f"{name}.pkl", "rb") as f:
            rows[name] = pickle.load(f)
    assert [r["step"] for r in rows["resumed"]] == [5, 6, 7, 8]
    for r in rows["resumed"]:
        f = rows["full"][r["step"] - 1]
        assert (r["Loss"], r["lr"], r["grad_norm"]) == (f["Loss"], f["lr"], f["grad_norm"])
    saved = safetensors_io.load_file(str(step4 / "device_state.safetensors"))
    cfg = load_config(model)
    shapes = tllama.flatten_params(tllama.shapes(cfg))
    params = sorted(k for k in saved if k.startswith("params."))
    assert len(params) == len(shapes)
    assert sorted(tuple(saved[k].shape) for k in params) == sorted(tuple(s) for s in shapes)
