"""The GPipe pipeline (pp) of the port against the JAX package, on the CPU.

The cases of ``tests/test_pipeline.py`` run over gloo ranks of separate
processes (``tests/torch_dist_child.py``), one launch a world size, on
numpy params and batches that the JAX trainer takes too, all in f32. The
JAX oracle is its own: the sequential trainer, which the JAX pipeline
equals (its tests hold that at atol 2e-5), and the JAX pipeline itself at
pp 2. Tolerances, each with its reason:

- losses atol 2e-5 (5e-5 with the ring, as ``test_sp_pp_composes_with_ring_attention``)
  and rtol 1e-5, grad norms rtol 1e-5, the whole params after three steps
  atol 1e-5 (as ``tests/test_torch_parallel.py`` holds the strategies):
  stages and micro-batches re-associate the f32 sums of the gradients,
  and AdamW carries their relative error into lr-sized updates;
- the MoE loss at M 2 atol 1e-4, the JAX test's bound for its oracle built
  from per-micro-batch forwards; the same bound holds the MoE losses, aux
  and gradients under capacity drops against the JAX pipeline (the
  routed sums re-associate over ranks and micro-batches in f32), while the
  tokens dropped per layer, integer decisions, are held exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opendiloco_tpu.models import llama as jllama
from opendiloco_tpu.parallel.mesh import build_mesh as jbuild_mesh
from opendiloco_tpu.parallel.sharding import param_specs as jparam_specs
from opendiloco_tpu.trainer import InnerTrainer as JInnerTrainer
from opendiloco_tpu.trainer import TrainerConfig as JTrainerConfig
from opendiloco_torch.models import llama as tllama
from opendiloco_torch.parallel.mesh import layout_plan, loopback_plans
from opendiloco_torch.parallel.sharding import param_specs
from opendiloco_torch.trainer import InnerTrainer, TrainerConfig
from torch_dist_child import spawn

torch.set_num_threads(2)

PP_CFG = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=4, num_attention_heads=4,
              num_key_value_heads=2, max_position_embeddings=64)
# the fused loss's kernels tile D 128 (a hidden of 64 takes the materializing branch)
FUSED_CFG = dict(PP_CFG, hidden_size=128, intermediate_size=256)
MOE_CFG = dict(PP_CFG, num_hidden_layers=2, num_experts=4, expert_capacity_factor=1.25)
TC = dict(lr=1e-3, warmup_steps=2, total_steps=50, precision="fp32", remat=False)
# name: (strategy, mesh kwargs, world, TrainerConfig overrides); attention
# "auto": plain on the CPU, the ring under sp
CASES = {
    "pp2": ("NO_SHARD", {"pp_size": 2}, 2, {}),
    "pp2 M4": ("NO_SHARD", {"pp_size": 2}, 2, {"pp_microbatches": 4}),
    "pp4": ("NO_SHARD", {"pp_size": 4}, 4, {}),
    "sp2 pp2 ring": ("NO_SHARD", {"pp_size": 2, "sp_size": 2}, 4, {}),
    "sp2 pp2 activation sharding": ("NO_SHARD", {"pp_size": 2, "sp_size": 2}, 4,
                                    {"allow_sp_activation_sharding": True}),
    # JAX runs XLA attention here (a nested shard_map has no jvp); the port
    # keeps the kernels (their plain versions on the CPU)
    "pp2 dp2 pallas": ("NO_SHARD", {"pp_size": 2, "dp_size": 2}, 4, {"attn_impl": "pallas"}),
    "pp2 fsdp2 dp2 remat": ("HYBRID_SHARD", {"pp_size": 2, "dp_size": 2, "fsdp_size": 2}, 8, {"remat": True}),
}
FUSED_CASE = ("NO_SHARD", {"pp_size": 2}, {"fused_loss": True})
MOE_CASES = {"pp2 M1": ("NO_SHARD", {"pp_size": 2}, 2, {"pp_microbatches": 1}),
             "pp2 ep2 M2": ("NO_SHARD", {"pp_size": 2, "ep_size": 2}, 4, {"pp_microbatches": 2})}


def _np_params(cfg, seed):
    rng = np.random.default_rng(seed)

    def draw(tree, name=""):
        if isinstance(tree, dict):
            return {k: draw(v, k) for k, v in tree.items()}
        base, scale = (1.0, 0.1) if "norm" in name else (0.0, 0.05)
        return (base + scale * rng.standard_normal(tree)).astype(np.float32)

    return draw(tllama.shapes(cfg))


def _data(n=8, t=32, seed=0):
    ids = np.random.default_rng(seed).integers(0, 256, (n, t)).astype(np.int32)
    return ids, ids.copy()


def _jax_run(cfg, strategy, kw, world, params, batches, ev, **tc):
    jt = JInnerTrainer(cfg, JTrainerConfig(**{**TC, **tc}), jbuild_mesh(strategy, devices=jax.devices()[:world], **kw))
    state = jt.init_state(jax.random.key(0), params)
    losses, norms = [], []
    for ids, labels in batches:
        state, m = jt.train_step(state, jt.shard_batch(ids, labels, accum=1))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    out = {"losses": losses, "norms": norms,
           "params": [np.asarray(x) for x in jax.tree.leaves(jax.device_get(state["params"]))]}
    if ev is not None:
        out["eval"] = jt.eval_loss(state["params"], *ev)
        out["probe"] = jt.probe_norms(state["params"], ev[0])
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case over its gloo ranks (one launch a world size), and the
    JAX oracles on the same params and batches."""
    cfg, fcfg, mcfg = (tllama.LlamaConfig(**c) for c in (PP_CFG, FUSED_CFG, MOE_CFG))
    params, fparams, mparams = _np_params(cfg, 3), _np_params(fcfg, 4), _np_params(mcfg, 5)
    batches = [_data(seed=s) for s in range(3)]
    fbatches = [_data(t=33, seed=s) for s in range(2)]  # 8 x 32 shifted tokens: the kernel's tiles
    mbatch = [_data(seed=2)]
    ev = _data(seed=9)
    tmp = tmp_path_factory.mktemp("pipeline")
    got = {}
    for world in (2, 4, 8):
        jobs = []
        cases = {k: (s, kw, tc) for k, (s, kw, w, tc) in CASES.items() if w == world}
        jobs.append(("strategies", dict(cfg=PP_CFG, params=params, batches=batches, eval=ev, tc=TC, accum=1,
                                        cases=cases)))
        if world == 2:
            jobs.append(("strategies", dict(cfg=FUSED_CFG, params=fparams, batches=fbatches, eval=fbatches[0], tc=TC,
                                            accum=1, cases={"fused": FUSED_CASE})))
        moe = {k: (s, kw, {"attn_impl": "xla", **tc}) for k, (s, kw, w, tc) in MOE_CASES.items() if w == world}
        if moe:
            jobs.append(("strategies", dict(cfg=MOE_CFG, params=mparams, batches=mbatch, eval=mbatch[0], tc=TC,
                                            accum=1, cases=moe)))
        ranks = spawn("many", world, {"jobs": jobs}, tmp, timeout=180.0)
        for job in range(len(jobs)):
            for case, res in ranks[0][job].items():
                got[case] = {**res, "ranks": [r[job][case] for r in ranks]}
    jref = _jax_run(cfg, "NO_SHARD", {}, 1, params, batches, ev)
    jpp = _jax_run(cfg, "NO_SHARD", {"pp_size": 2}, 2, params, batches, None)
    jfused = _jax_run(fcfg, "NO_SHARD", {}, 1, fparams, fbatches, None)
    # the MoE oracles of test_moe_pp_loss_matches_sequential: the unpipelined
    # loss (M 1), and the mean over per-micro-batch unpipelined forwards (M 2)
    jmoe = _jax_run(mcfg, "NO_SHARD", {}, 1, mparams, mbatch, None, attn_impl="xla")
    jp = jax.tree.map(jnp.asarray, mparams)
    ids = jnp.asarray(mbatch[0][0])
    xents, auxs = [], []
    for half in (ids[:4], ids[4:]):
        logits, aux = jllama.forward(jp, half, mcfg, compute_dtype=jnp.float32, remat=False, return_moe_aux=True)
        xents.append(float(jllama.causal_lm_loss(logits, half)))
        auxs.append(float(aux))
    jmoe_m2 = float(np.mean(xents)) + mcfg.router_aux_coef * float(np.mean(auxs))
    return {"got": got, "jref": jref, "jpp": jpp, "jfused": jfused, "jmoe": jmoe, "jmoe_m2": jmoe_m2}


def _assert_trajectory(got: dict, want: dict, atol: float = 2e-5) -> None:
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5, atol=atol)
    np.testing.assert_allclose(got["norms"], want["norms"], rtol=1e-5)
    assert len(got["params"]) == len(want["params"])
    for a, b in zip(got["params"], want["params"]):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)


@pytest.mark.parametrize("case", list(CASES))
def test_pipeline_trajectory_matches_jax(runs, case):
    """Three steps through the pipeline (forward, the reverse schedule,
    AdamW) at every case: every rank reports the same losses and grad
    norms, which with the whole params after the last step (``gather_state``)
    equal the JAX sequential trainer's; the eval loss and the probes (the
    pipelined forward without gradients) too."""
    got = runs["got"][case]
    for r in got["ranks"]:
        assert r["losses"] == got["losses"] and r["norms"] == got["norms"]
    _assert_trajectory(got, runs["jref"], atol=5e-5 if "ring" in case else 2e-5)
    assert got["eval"] == pytest.approx(runs["jref"]["eval"], rel=1e-5)
    assert sorted(got["probe"]) == sorted(runs["jref"]["probe"])
    for k, v in runs["jref"]["probe"].items():
        assert got["probe"][k] == pytest.approx(v, rel=1e-5), k


def test_pp2_matches_the_jax_pipeline(runs):
    """pp 2 against the JAX package's own pipeline (its shard_map scan over
    pp), on two virtual devices."""
    _assert_trajectory(runs["got"]["pp2"], runs["jpp"])


@pytest.mark.parametrize("case", ["pp2", "pp2 M4", "pp4"])
def test_replicated_leaves_are_identical_on_every_stage(runs, case):
    """Embed, final norm and head (whole on every stage; their gradients
    come from stage 0 and the last stage) carry the same bits on every
    stage after every step."""
    ranks = runs["got"][case]["ranks"]
    assert len(ranks[0]["whole"][0]) == 3  # embed_tokens, final_norm, lm_head
    for r in ranks[1:]:
        assert r["whole"] == ranks[0]["whole"]


def test_fused_loss_under_pp_matches_jax(runs):
    """The fused lm-head + cross-entropy (its kernels' plain versions) on
    the last stage's joined hidden states: the trajectory equals the JAX
    trainer's materialized loss (the oracle of ``test_pp_composes_with_fused_loss``)."""
    _assert_trajectory(runs["got"]["fused"], runs["jfused"])


def test_moe_pp_loss_matches_sequential(runs):
    """The router aux rides each stage's accumulators: at M 1 the first-step
    loss is the unpipelined JAX loss; at M 2 under pp x ep every router
    statistic is per micro-batch, and the loss is the mean of the JAX
    per-micro-batch forwards (aux over L x M)."""
    np.testing.assert_allclose(runs["got"]["pp2 M1"]["losses"][0], runs["jmoe"]["losses"][0], atol=2e-5)
    np.testing.assert_allclose(runs["got"]["pp2 ep2 M2"]["losses"][0], runs["jmoe_m2"], atol=1e-4)
    for case in MOE_CASES:
        assert all(r["losses"] == runs["got"][case]["losses"] for r in runs["got"][case]["ranks"])


# routed experts under capacity drops (config_2m_4e's shapes at capacity
# factor 0.5): name -> (strategy, mesh kwargs, world, TrainerConfig
# overrides, sp chunks the JAX pipeline routes apart)
DROP_CFG = dict(vocab_size=1024, hidden_size=64, intermediate_size=256, num_hidden_layers=2, num_attention_heads=2,
                num_experts=4, expert_capacity_factor=0.5)
DROP_CASES = {
    "pp2 dp2 M2": ("NO_SHARD", {"pp_size": 2, "dp_size": 2}, 4, {"pp_microbatches": 2, "attn_impl": "xla"}, 1),
    "sp2 pp2": ("NO_SHARD", {"pp_size": 2, "sp_size": 2}, 4, {"attn_impl": "auto"}, 2),
    "dp2 sp2 pp2": ("NO_SHARD", {"pp_size": 2, "dp_size": 2, "sp_size": 2}, 8, {"attn_impl": "auto"}, 2),
}


def _jax_drops_oracle(cfg, params, ids, microbatches, chunks):
    """The JAX pipeline's routing, unpipelined: each global micro-batch
    (rows ``m B/M + [0, B/M)``) through the JAX forward with jit off, its
    ``_switch_ffn`` run on each of ``chunks`` sequence chunks apart (the
    JAX pipeline's manual sp), counting the tokens each call drops. ->
    (the loss, the aux, drops[m][layer])."""
    orig = jllama._switch_ffn
    drops: list = []

    def routed(cfg_, x, layer):
        ys, auxs, n = [], [], 0
        for xc in jnp.split(x, chunks, axis=1):
            y, aux = orig(cfg_, xc, layer)
            ys.append(y)
            auxs.append(aux)
            N = xc.shape[0] * xc.shape[1]
            cap = max(1, int(np.ceil(N / cfg_.num_experts * cfg_.expert_capacity_factor)))
            e = np.asarray(jnp.argmax(xc.reshape(N, -1) @ layer["router"], axis=-1))
            n += int(sum(max(0, int((e == k).sum()) - cap) for k in range(cfg_.num_experts)))
        drops[-1].append(n)
        return jnp.concatenate(ys, axis=1), sum(auxs) / chunks

    jp = jax.tree.map(jnp.asarray, params)
    xents, auxs = [], []
    jllama._switch_ffn = routed
    try:
        with jax.disable_jit():
            for mb in np.split(ids, microbatches):
                drops.append([])
                logits, aux = jllama.forward(jp, jnp.asarray(mb), cfg, compute_dtype=jnp.float32, remat=False,
                                             return_moe_aux=True)
                xents.append(float(jllama.causal_lm_loss(logits, jnp.asarray(mb))))
                auxs.append(float(aux))
    finally:
        jllama._switch_ffn = orig
    return float(np.mean(xents)) + cfg.router_aux_coef * float(np.mean(auxs)), float(np.mean(auxs)), drops


def _jax_moe_pipeline(cfg, kw, world, params, batch, tc):
    """The JAX trainer's loss and its gradients (the leaves in flatten
    order) and the pipelined forward's aux, on ``world`` virtual devices."""
    jt = JInnerTrainer(cfg, JTrainerConfig(**{**TC, **tc}), jbuild_mesh("NO_SHARD", devices=jax.devices()[:world],
                                                                        **kw))
    state = jt.init_state(jax.random.key(0), params)
    b = jt.shard_batch(*batch, accum=1)
    ids, labels = b["input_ids"][0], b["labels"][0]
    loss, grads = jax.jit(jax.value_and_grad(jt._loss_fn))(state["params"], ids, labels)
    mesh = jt.plan.mesh
    fwd = jax.jit(lambda p, x: jllama.forward(
        p, x, cfg, pp_mesh=mesh, pp_axis="pp", pp_microbatches=jt.tc.pp_microbatches, ring_mesh=mesh,
        ring_axis=jt.plan.sp_axis or "sp", batch_axes=jt.plan.batch_axes, compute_dtype=jnp.float32,
        attn_impl=jt.tc.attn_impl, remat=False, return_moe_aux=True)[1])
    return float(loss), float(fwd(state["params"], ids)), [np.asarray(g) for g in jax.tree.leaves(grads)]


@pytest.fixture(scope="module")
def drop_runs(tmp_path_factory):
    """The MoE cases under capacity drops over their gloo ranks (one launch a
    world size), the JAX pipeline on as many virtual devices, and the
    routing oracle of each."""
    cfg = tllama.LlamaConfig(**DROP_CFG)
    params = _np_params(cfg, 6)
    ids = np.random.default_rng(11).integers(0, cfg.vocab_size, (8, 32)).astype(np.int32)
    tmp = tmp_path_factory.mktemp("pipeline_drops")
    out = {}
    for world in (4, 8):
        cases = {k: (s, kw, tc) for k, (s, kw, w, tc, _) in DROP_CASES.items() if w == world}
        spec = {"cfg": DROP_CFG, "params": params, "batch": (ids, ids.copy()), "tc": TC, "cases": cases}
        ranks = spawn("moe_pp", world, spec, tmp, timeout=180.0)
        for case in cases:
            out[case] = {"ranks": [r[case] for r in ranks]}
    for case, (_, kw, world, tc, chunks) in DROP_CASES.items():
        out[case]["jax"] = _jax_moe_pipeline(cfg, kw, world, params, (ids, ids.copy()), tc)
        M = tc.get("pp_microbatches") or kw["pp_size"]
        out[case]["oracle"] = _jax_drops_oracle(cfg, params, ids, M, chunks)
    return out


@pytest.mark.parametrize("case", list(DROP_CASES))
def test_moe_under_pp_matches_the_jax_pipeline_with_drops(drop_runs, case):
    """Routed experts under capacity drops through the pipeline beside dp
    (each rank's micro-batch m holds its share of the JAX pipeline's global
    micro-batch m) and beside sp (each sequence chunk routes on its own, as
    in the JAX pipeline's manual sp region): the loss, the aux and the
    whole gradients equal the JAX pipeline's, and the tokens dropped at
    each layer of each micro-batch equal the JAX routing's (its oracle's
    loss equals the JAX pipeline's, which shows it routes the same way)."""
    run = drop_runs[case]
    jloss, jaux, jgrads = run["jax"]
    oloss, oaux, odrops = run["oracle"]
    np.testing.assert_allclose(oloss, jloss, atol=1e-4)
    np.testing.assert_allclose(oaux, jaux, atol=1e-4)
    assert sum(map(sum, odrops)) > 0  # capacity binds
    for r in run["ranks"]:
        np.testing.assert_allclose(r["loss"], jloss, atol=1e-4)
        np.testing.assert_allclose(r["aux"], jaux, atol=1e-4)
        assert len(r["grads"]) == len(jgrads)
        for a, b in zip(r["grads"], jgrads):
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)
        # this stage runs one of the two layers, each micro-batch in turn
        assert r["drops"] == [odrops[m][r["pp_rank"]] for m in range(len(odrops))]


def test_stage_holds_its_layers(runs):
    """A stage holds L/pp contiguous layers of every stacked leaf (the norm
    vectors too) and the whole embed, final norm and head."""
    full = tllama.shapes(tllama.LlamaConfig(**PP_CFG))
    for case, n in (("pp2", 2), ("pp4", 4)):
        shapes = tllama.unflatten_params(full, runs["got"][case]["shapes"]["params"])
        for name, shape in full["layers"].items():
            assert shapes["layers"][name] == (shape[0] // n, *shape[1:]), (case, name)
        assert shapes["embed_tokens"] == full["embed_tokens"] and shapes["lm_head"] == full["lm_head"]


@pytest.mark.parametrize("for_params", [True, False], ids=["params", "optstate"])
@pytest.mark.parametrize("strategy,kw", [("NO_SHARD", {"pp_size": 2}), ("HYBRID_SHARD", {"pp_size": 2, "fsdp_size": 2}),
                                         ("FULL_SHARD", {"pp_size": 2, "tp_size": 2}),
                                         ("NO_SHARD", {"pp_size": 4, "tp_size": 2})])
def test_pp_param_specs_match_jax(strategy, kw, for_params):
    """The specs of every leaf on eight devices under pp (and tp, fsdp
    beside it) are the JAX package's: the layer dim over pp, the norm
    vectors' too."""
    cfg = tllama.LlamaConfig(**PP_CFG)
    got = tllama.flatten_params(param_specs(cfg, layout_plan(strategy, 8, **kw), for_params=for_params))
    jspecs = jparam_specs(cfg, jbuild_mesh(strategy, devices=jax.devices()[:8], **kw), for_params=for_params)
    want = [tuple(p) for p in jax.tree.leaves(jspecs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))]
    assert got == want


def test_pp_requires_divisible_layers():
    """Layers that pp does not divide: the specs leave the layer dim whole
    (as JAX's), and the trainer refuses with the JAX text."""
    cfg = tllama.LlamaConfig(**{**PP_CFG, "num_hidden_layers": 3})
    plan = layout_plan("NO_SHARD", 2, pp_size=2)
    assert all("pp" not in s for s in tllama.flatten_params(param_specs(cfg, plan)))
    with pytest.raises(ValueError, match="3 layers cannot stage over pp=2"):
        InnerTrainer(cfg, TrainerConfig(**TC), device="cpu", plan=plan)


def test_sp_pp_non_ring_requires_explicit_optin():
    """A non-ring attention under sp + pp is refused without the opt-in
    (the JAX text), ring attention under pp needs sp, and with the opt-in
    the attention resolves to the full-sequence kind (its run is the case
    "sp2 pp2 activation sharding" above)."""
    cfg = tllama.LlamaConfig(**PP_CFG)
    plan = layout_plan("NO_SHARD", 4, pp_size=2, sp_size=2)
    with pytest.raises(ValueError, match="allow-sp-activation-sharding"):
        InnerTrainer(cfg, TrainerConfig(**TC, attn_impl="xla"), device="cpu", plan=plan)
    tr = InnerTrainer(cfg, TrainerConfig(**TC, allow_sp_activation_sharding=True), device="cpu", plan=plan)
    assert tr.tc.attn_impl == "xla"
    assert InnerTrainer(cfg, TrainerConfig(**TC), device="cpu", plan=plan).tc.attn_impl == "ring"
    with pytest.raises(ValueError, match="ring attention under pp needs a sequence-parallel axis"):
        InnerTrainer(cfg, TrainerConfig(**TC, attn_impl="ring"), device="cpu", plan=layout_plan("NO_SHARD", 2,
                                                                                                    pp_size=2))


def _loopback(plans, fn):
    import threading

    out, errors = [None] * len(plans), []

    def one(r):
        try:
            out[r] = fn(plans[r])
        except BaseException as e:  # pragma: no cover - re-raised below
            errors.append(e)
            for c in plans[r].comms.values():
                c.g.abort()

    threads = [threading.Thread(target=one, args=(r,)) for r in range(len(plans))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out


def test_loopback_stages_match_one_device_and_forward_replicates():
    """pp 2 over the loopback exchange (the path over one card, here rank
    threads on the CPU): the gradients each stage hands AdamW, joined, are
    the single-device trainer's; the pipelined ``forward`` (no gradients)
    gives every stage the unsplit logits."""
    cfg = tllama.LlamaConfig(**PP_CFG)
    params = _np_params(cfg, 7)
    ids, labels = _data(seed=1)

    def grads_of(plan):
        tr = InnerTrainer(cfg, TrainerConfig(**TC), device="cpu", plan=plan)
        state = tr.init_state(params=params)
        seen = {}
        tr.optimizer.update = lambda g, *a: seen.setdefault("g", [x.clone() for x in g])
        tr.train_step(state, tr.shard_batch(ids, labels, accum=1))
        whole = [tr._whole(g, i, None).numpy() for i, g in enumerate(seen["g"])]
        with torch.no_grad():
            logits = tllama.forward(state["params"], torch.from_numpy(ids).long(), cfg, compute_dtype=torch.float32,
                                    remat=False, **({} if tr._pp is None else {"pp_mesh": tr._pp}))
        return whole, logits.numpy()

    want, want_logits = grads_of(layout_plan())
    for got, logits in _loopback(loopback_plans(pp_size=2), grads_of):
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-5)
        np.testing.assert_allclose(logits, want_logits, atol=1e-5, rtol=1e-5)


def test_cli_at_pp2_checkpoints_whole_leaves_and_resumes(tmp_path):
    """``python -m opendiloco_torch.train --pp-size 2`` over two processes
    of one worker: a checkpoint at step 4 holds whole leaves, and the run
    resumed from it repeats steps 5-8 bit for bit (loss, lr, grad norm)."""
    import pickle

    from opendiloco_torch.models.hf_io import load_config
    from opendiloco_torch.utils import safetensors_io
    from test_torch_sharded_train import _launch

    args = ["--path-model", "2m", "--fake-data", "--fake-data-mode", "ramp", "--seq-length", "64",
            "--per-device-train-batch-size", "4", "--total-batch-size", "8", "--total-steps", "8",
            "--warmup-steps", "2", "--lr", "1e-3", "--precision", "fp32", "--metric-logger-type", "dummy",
            "--ckpt.interval", "4", "--pp-size", "2"]

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
    shapes = tllama.flatten_params(tllama.shapes(load_config("2m")))
    params = sorted(k for k in saved if k.startswith("params."))
    assert sorted(tuple(saved[k].shape) for k in params) == sorted(tuple(s) for s in shapes)
