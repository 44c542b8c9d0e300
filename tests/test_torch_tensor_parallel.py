"""Tensor parallelism (tp, Megatron) of the port against the JAX package,
on the CPU.

The cases run over gloo ranks of separate processes
(``tests/torch_dist_child.py``), one launch a world size, on numpy params
and batches that the JAX trainer takes too, all in f32: tp 2 alone and
beside FULL_SHARD, dp, sp (the ring on a rank's heads) and pp, tp 4 over
2 kv heads (k and v gathered over tp, each rank attending with the kv
heads its q heads need), the fused loss over the head gathered over tp
(the JAX kernel in interpret mode), and config_2m_4e's routed experts with
their FFN columns cut over tp. The oracle is the JAX trainer, on one
device (``test_tensor_parallel_equivalence`` holds JAX's tp to it) and at
tp 2 itself. Tolerances: losses and grad norms rtol 1e-5 (atol 1e-5 for
the losses, as that test; 5e-5 with the ring, as the JAX sp + pp test),
the whole params after three steps atol 1e-5: the ranks' partial sums
re-associate the f32 additions of the row-parallel products and of the
gradients, and AdamW carries their relative error into lr-sized updates.
"""
import dataclasses
import threading

import jax
import numpy as np
import pytest
import torch

from opendiloco_tpu.parallel.mesh import build_mesh as jbuild_mesh
from opendiloco_tpu.parallel.sharding import param_specs as jparam_specs
from opendiloco_tpu.trainer import InnerTrainer as JInnerTrainer
from opendiloco_tpu.trainer import TrainerConfig as JTrainerConfig
from opendiloco_torch.models import llama as tllama
from opendiloco_torch.models.hf_io import load_config
from opendiloco_torch.parallel.mesh import layout_plan, loopback_plans
from opendiloco_torch.parallel.sharding import param_specs
from opendiloco_torch.trainer import InnerTrainer, TrainerConfig
from torch_dist_child import spawn

torch.set_num_threads(2)

CFG = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
           num_key_value_heads=2, max_position_embeddings=128)
FUSED_CFG = dict(CFG, hidden_size=128, intermediate_size=256)  # the fused loss's kernels tile D 128
TC = dict(lr=1e-3, warmup_steps=2, total_steps=100, precision="fp32", remat=False)
# name: (strategy, mesh kwargs, world, TrainerConfig overrides); attention
# "auto": plain on the CPU, the ring under sp
CASES = {
    "tp2": ("NO_SHARD", {"tp_size": 2}, 2, {}),
    "tp2 pallas remat": ("NO_SHARD", {"tp_size": 2}, 2, {"attn_impl": "pallas", "remat": True}),
    "tp2 full shard": ("FULL_SHARD", {"tp_size": 2}, 4, {}),
    "tp2 dp2": ("NO_SHARD", {"tp_size": 2}, 4, {}),
    "tp4 over 2 kv heads": ("NO_SHARD", {"tp_size": 4}, 4, {}),
    "tp2 sp2": ("NO_SHARD", {"tp_size": 2, "sp_size": 2}, 4, {}),
    "tp2 pp2": ("NO_SHARD", {"tp_size": 2, "pp_size": 2}, 4, {}),
}
FUSED_CASE = ("NO_SHARD", {"tp_size": 2}, {"fused_loss": True})
MOE_CASE = ("NO_SHARD", {"tp_size": 2}, {"attn_impl": "xla"})


def _np_params(cfg, seed):
    rng = np.random.default_rng(seed)

    def draw(tree, name=""):
        if isinstance(tree, dict):
            return {k: draw(v, k) for k, v in tree.items()}
        base, scale = (1.0, 0.1) if "norm" in name else (0.0, 0.05)
        return (base + scale * rng.standard_normal(tree)).astype(np.float32)

    return draw(tllama.shapes(cfg))


def _batches(vocab: int, n: int = 3, bs: int = 8, seq: int = 32, seed: int = 11):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(0, vocab, (bs, seq)).astype(np.int32)
        out.append((ids, ids.copy()))
    return out


def _jax_run(cfg, kw, world, params, batches, ev=None, **tc):
    jt = JInnerTrainer(cfg, JTrainerConfig(**{**TC, **tc}), jbuild_mesh("NO_SHARD", devices=jax.devices()[:world], **kw))
    state = jt.init_state(jax.random.key(0), params)
    losses, norms = [], []
    for ids, labels in batches:
        state, m = jt.train_step(state, jt.shard_batch(ids, labels, accum=2))
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
    import jax.experimental.pallas as pl

    from opendiloco_tpu.ops import fused_xent as jfused

    cfg, fcfg, mcfg = tllama.LlamaConfig(**CFG), tllama.LlamaConfig(**FUSED_CFG), load_config("2m_4e")
    params, fparams, mparams = _np_params(cfg, 6), _np_params(fcfg, 7), _np_params(mcfg, 8)
    batches = _batches(cfg.vocab_size)
    fbatches = _batches(cfg.vocab_size, n=2, seq=33)  # 8 x 32 shifted tokens: the kernel's tiles
    mbatches = _batches(mcfg.vocab_size, n=2, seq=64)
    ev = _batches(cfg.vocab_size, n=1, seed=5)[0]
    tmp = tmp_path_factory.mktemp("tp")
    got = {}
    for world in (2, 4):
        cases = {k: (s, kw, tc) for k, (s, kw, w, tc) in CASES.items() if w == world}
        jobs = [("strategies", dict(cfg=CFG, params=params, batches=batches, eval=ev, tc=TC, accum=2, cases=cases))]
        if world == 2:
            jobs.append(("strategies", dict(cfg=FUSED_CFG, params=fparams, batches=fbatches, eval=fbatches[0], tc=TC,
                                            accum=2, cases={"fused": FUSED_CASE})))
            jobs.append(("strategies", dict(cfg=dataclasses.asdict(mcfg), params=mparams, batches=mbatches, eval=mbatches[0],
                                            tc=TC, accum=2, cases={"2m_4e": MOE_CASE})))
        ranks = spawn("many", world, {"jobs": jobs}, tmp, timeout=180.0)
        for job in range(len(jobs)):
            for case, res in ranks[0][job].items():
                got[case] = {**res, "ranks": [r[job][case] for r in ranks]}
    out = {"got": got, "jref": _jax_run(cfg, {}, 1, params, batches, ev),
           "jtp": _jax_run(cfg, {"tp_size": 2}, 2, params, batches),
           "jmoe": _jax_run(mcfg, {}, 1, mparams, mbatches, attn_impl="xla")}
    # the JAX fused loss at tp 2 with its kernels in interpret mode (as the
    # interpret_pallas_fused fixture runs them)
    orig = pl.pallas_call
    jfused.pl.pallas_call = lambda *a, **k: orig(*a, **{**k, "interpret": True})
    try:
        out["jfused"] = _jax_run(fcfg, {"tp_size": 2}, 2, fparams, fbatches, fused_loss=True)
    finally:
        jfused.pl.pallas_call = orig
    return out


def _assert_trajectory(got: dict, want: dict, atol: float = 1e-5) -> None:
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5, atol=atol)
    np.testing.assert_allclose(got["norms"], want["norms"], rtol=1e-5)
    assert len(got["params"]) == len(want["params"])
    for a, b in zip(got["params"], want["params"]):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)


@pytest.mark.parametrize("case", list(CASES))
def test_tensor_parallel_trajectory_matches_jax(runs, case):
    """Three steps at accum 2 of every case: every rank reports the same
    losses and grad norms, which with the whole params after the last step
    equal the JAX trainer's on one device; the eval loss and the probes
    (the attn-output norms after the row-parallel sum) too."""
    got = runs["got"][case]
    for r in got["ranks"]:
        assert r["losses"] == got["losses"] and r["norms"] == got["norms"]
    _assert_trajectory(got, runs["jref"], atol=5e-5 if "sp" in case else 1e-5)
    assert got["eval"] == pytest.approx(runs["jref"]["eval"], rel=1e-5)
    for k, v in runs["jref"]["probe"].items():
        assert got["probe"][k] == pytest.approx(v, rel=1e-5), k


def test_tp2_matches_the_jax_tp2_trainer(runs):
    """tp 2 against the JAX trainer on a tp-2 mesh of two virtual devices
    (``test_tensor_parallel_equivalence``'s layout, its collectives from
    the partitioner)."""
    _assert_trajectory(runs["got"]["tp2"], runs["jtp"])


def test_fused_loss_over_a_head_gathered_over_tp_matches_jax(runs):
    """The fused lm-head + cross-entropy with the head gathered over tp
    (the kernels' plain versions): the JAX tp-2 trainer's fused loss, its
    kernel in interpret mode."""
    _assert_trajectory(runs["got"]["fused"], runs["jfused"])


def test_routed_experts_with_tp_cut_ffn_match_jax(runs):
    """config_2m_4e at tp 2: each rank holds half of every expert's FFN
    columns; routing, capacity and the aux are the same on both ranks, and
    the trajectory is the JAX trainer's."""
    got = runs["got"]["2m_4e"]
    L, E, D, F = tllama.shapes(load_config("2m_4e"))["layers"]["gate_proj"]
    assert tllama.unflatten_params(tllama.shapes(load_config("2m_4e")),
                                   got["shapes"]["params"])["layers"]["gate_proj"] == (L, E, D, F // 2)
    _assert_trajectory(got, runs["jmoe"])


@pytest.mark.parametrize("case", ["tp2", "tp4 over 2 kv heads"])
def test_leaves_tp_does_not_cut_are_identical_on_every_rank(runs, case):
    """The norms (whole on every tp rank; their gradients are whole on each
    rank, never summed over tp) carry the same bits on every rank after
    every step."""
    ranks = runs["got"][case]["ranks"]
    assert len(ranks[0]["whole"][0]) == 3  # final_norm, input_norm, post_attn_norm
    for r in ranks[1:]:
        assert r["whole"] == ranks[0]["whole"]


def test_ranks_hold_the_megatron_blocks(runs):
    """At tp 2 a rank holds half of the heads of q/k/v (columns) and o
    (rows), half of the FFN's columns, and half of the vocab of embed and
    head; the norms whole."""
    full = tllama.shapes(tllama.LlamaConfig(**CFG))
    got = tllama.unflatten_params(full, runs["got"]["tp2"]["shapes"]["params"])
    L, D, Q = full["layers"]["q_proj"]
    assert got["layers"]["q_proj"] == (L, D, Q // 2) and got["layers"]["o_proj"] == (L, Q // 2, D)
    assert got["layers"]["k_proj"][2] == full["layers"]["k_proj"][2] // 2
    assert got["layers"]["down_proj"] == (L, CFG["intermediate_size"] // 2, D)
    assert got["embed_tokens"] == (CFG["vocab_size"] // 2, D) and got["lm_head"] == (D, CFG["vocab_size"] // 2)
    assert got["final_norm"] == full["final_norm"] and got["layers"]["input_norm"] == full["layers"]["input_norm"]


@pytest.mark.parametrize("for_params", [True, False], ids=["params", "optstate"])
@pytest.mark.parametrize("strategy,kw", [("NO_SHARD", {"tp_size": 2}), ("FULL_SHARD", {"tp_size": 2}),
                                         ("HYBRID_SHARD", {"tp_size": 2, "fsdp_size": 2}),
                                         ("NO_SHARD", {"tp_size": 8}), ("FULL_SHARD", {"tp_size": 4})])
def test_tp_param_specs_match_jax(strategy, kw, for_params):
    """The specs of every leaf on eight devices under tp (fsdp falling back
    to another dim where tp took the preferred one) are the JAX
    package's."""
    cfg = tllama.LlamaConfig(**CFG)
    got = tllama.flatten_params(param_specs(cfg, layout_plan(strategy, 8, **kw), for_params=for_params))
    jspecs = jparam_specs(cfg, jbuild_mesh(strategy, devices=jax.devices()[:8], **kw), for_params=for_params)
    want = [tuple(p) for p in jax.tree.leaves(jspecs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))]
    assert got == want


@pytest.mark.parametrize("tp", [2, 3, 4, 8])
def test_gradients_are_not_multiplied_by_tp(tp):
    """Over the loopback group (the path over one card, here rank threads
    on the CPU): the gradients each rank hands AdamW, joined over tp, are
    the single-device trainer's, those of the head and the norms (whole on
    every rank) included. tp 4 gathers k and v (2 kv heads); tp 8 splits
    the 4 heads' columns, so every rank attends with all heads and
    multiplies its rows of o_proj; tp 3 divides no Megatron dim (64, 32,
    128, 256), so every leaf stays whole and o_proj's rows are split
    unevenly over the ranks."""
    cfg = tllama.LlamaConfig(**CFG)
    params = _np_params(cfg, 9)
    ids, labels = _batches(cfg.vocab_size, n=1, seed=3)[0]

    def grads_of(plan):
        tr = InnerTrainer(cfg, TrainerConfig(**TC), device="cpu", plan=plan)
        state = tr.init_state(params=params)
        seen = {}
        tr.optimizer.update = lambda g, *a: seen.setdefault("g", [x.clone() for x in g])
        tr.train_step(state, tr.shard_batch(ids, labels, accum=1))
        return [tr._whole(g, i, None).numpy() for i, g in enumerate(seen["g"])]

    want = grads_of(layout_plan())
    plans, out, errors = loopback_plans(tp_size=tp), [None] * tp, []

    def one(r):
        try:
            out[r] = grads_of(plans[r])
        except BaseException as e:  # pragma: no cover - re-raised below
            errors.append(e)
            plans[r].comms["tp"].g.abort()

    threads = [threading.Thread(target=one, args=(r,)) for r in range(tp)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    for got in out:
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-5)


def test_cli_at_tp2_through_an_outer_round_equals_tp1(tmp_path, monkeypatch):
    """``python -m opendiloco_torch.train --tp-size 2`` over two processes
    of one worker, a galaxy of one over TCP, 4 steps of 2 outer rounds:
    each step's loss and grad norm equal the one-process run's (rtol
    1e-5), the lrs bit for bit."""
    import pickle

    from opendiloco_torch.diloco.rendezvous import RendezvousServer
    from test_torch_sharded_train import _launch

    monkeypatch.setenv("ODTP_EXPECT_PEERS", "1")
    args = ["--path-model", "2m", "--fake-data", "--fake-data-mode", "ramp", "--seq-length", "64",
            "--per-device-train-batch-size", "4", "--total-batch-size", "8", "--total-steps", "4",
            "--warmup-steps", "2", "--lr", "1e-3", "--precision", "fp32", "--metric-logger-type", "dummy",
            "--diloco.backend", "tcp", "--diloco.local-steps", "2"]
    daemons = [RendezvousServer("127.0.0.1", 0).start_in_thread() for _ in range(2)]
    try:
        two = [[*args, "--tp-size", "2", "--diloco.initial-peers", daemons[0].address, "--multihost",
                "--coordinator-address", f"file://{tmp_path / 'store'}", "--num-processes", "2", "--process-id",
                str(i), "--project", str(tmp_path / "tp2.pkl")] for i in range(2)]
        one = [*args, "--diloco.initial-peers", daemons[1].address, "--project", str(tmp_path / "tp1.pkl")]
        _launch([*two, one])
    finally:
        for d in daemons:
            d.stop()
    rows = {}
    for name in ("tp1", "tp2"):
        with open(tmp_path / f"{name}.pkl", "rb") as f:
            rows[name] = pickle.load(f)
    assert [r["step"] for r in rows["tp2"]] == [1, 2, 3, 4]
    assert sum("outer_step_s" in r for r in rows["tp2"]) == 2
    for a, b in zip(rows["tp2"], rows["tp1"]):
        assert a["Loss"] == pytest.approx(b["Loss"], rel=1e-5) and a["lr"] == b["lr"]
        assert a["grad_norm"] == pytest.approx(b["grad_norm"], rel=1e-5)
