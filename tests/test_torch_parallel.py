"""Intra-worker sharding of the port (``opendiloco_torch.parallel``) against
the JAX package, on the CPU.

The mesh arithmetic and the specs are pure and are compared with the JAX
functions on the conftest's virtual CPU devices. The strategies run in a
gloo group of separate processes (``tests/torch_dist_child.py``, a
``file://`` store under ``tmp_path``), four ranks and one, on the same
numpy params and global batches as the JAX trainer on four virtual
devices. Tolerances, all f32:

- four ranks against one rank and against JAX: loss rtol 1e-5, params
  atol 1e-5 (the JAX oracle's own bounds, tests/test_trainer.py: the sums
  over ranks re-associate f32 additions);
- one rank against the single-device trainer: bit for bit (every
  collective of one rank is an identity).
"""
import jax
import numpy as np
import pytest
import torch

from opendiloco_tpu.parallel.mesh import build_mesh as jbuild_mesh
from opendiloco_tpu.parallel.sharding import param_specs as jparam_specs
from opendiloco_tpu.trainer import InnerTrainer as JInnerTrainer
from opendiloco_tpu.trainer import TrainerConfig as JTrainerConfig
from opendiloco_torch.models import llama as tllama
from opendiloco_torch.parallel.mesh import build_mesh, layout_plan, mesh_sizes
from opendiloco_torch.parallel.sharding import join_blocks, local_block, optstate_specs, param_specs, spec_dim
from opendiloco_torch.trainer import InnerTrainer, TrainerConfig
from torch_dist_child import spawn

STRATEGIES = {
    "NO_SHARD": ("NO_SHARD", {}),
    "SHARD_GRAD_OP": ("SHARD_GRAD_OP", {}),
    "FULL_SHARD": ("FULL_SHARD", {}),
    "HYBRID_SHARD": ("HYBRID_SHARD", {"fsdp_size": 2}),
    "HYBRID_SHARD_ZERO2": ("HYBRID_SHARD_ZERO2", {"fsdp_size": 2}),
}
TC = dict(lr=1e-3, warmup_steps=2, total_steps=100, precision="fp32", remat=False, attn_impl="xla")
# the per-layer gather under recompute, the kernels' plain versions and the
# fused loss's sharded entry, held against the single-device port alone
KERNEL_PATH = {"FULL_SHARD, remat, pallas, fused loss": ("FULL_SHARD", {}, dict(remat=True, attn_impl="pallas",
                                                                                   fused_loss=True))}
CFG = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
           num_key_value_heads=2, max_position_embeddings=128)
IGNORE = -100


# ---------------------------------------------------------------------------
# the mesh arithmetic and the specs (pure)
# ---------------------------------------------------------------------------

MESH_CASES = [
    ("NO_SHARD", {}),
    ("SHARD_GRAD_OP", {}),
    ("FULL_SHARD", {}),
    ("HYBRID_SHARD", {"fsdp_size": 4}),
    ("HYBRID_SHARD_ZERO2", {"fsdp_size": 2}),
    ("HYBRID_SHARD", {}),
    ("HYBRID_SHARD", {"dp_size": 2}),
    ("HYBRID_SHARD_ZERO2", {"dp_size": 16}),
    ("NO_SHARD", {"tp_size": 3}),
    ("FULL_SHARD", {"sp_size": 2, "tp_size": 2}),
    ("BOGUS", {}),
]


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("strategy,kw", MESH_CASES, ids=[f"{s}-{kw}" for s, kw in MESH_CASES])
def test_mesh_sizes_and_errors_match_jax(n, strategy, kw):
    """The port's axis sizes are those of the JAX mesh on n of the virtual
    devices, and where JAX refuses the port raises the same ValueError
    text (the hybrid default shards within a host: the JAX process holds 8
    devices)."""
    try:
        jplan = jbuild_mesh(strategy, devices=jax.devices()[:n], **kw)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            mesh_sizes(strategy, n, local_count=jax.local_device_count(), **kw)
        assert str(got.value) == str(e)
        return
    sizes = mesh_sizes(strategy, n, local_count=jax.local_device_count(), **kw)
    assert sizes == dict(jplan.mesh.shape)
    plan = layout_plan(strategy, n, local_count=jax.local_device_count(), **kw)
    assert (plan.fsdp_axis, plan.tp_axis, plan.sp_axis, plan.batch_axes) == (
        jplan.fsdp_axis, jplan.tp_axis, jplan.sp_axis, jplan.batch_axes)
    assert plan.data_parallel_size == jplan.data_parallel_size


def test_without_a_group_the_plan_is_one_device_and_tp_raises():
    plan = build_mesh("FULL_SHARD")
    assert plan.mesh is None and plan.size == 1 and plan.fsdp_axis == "fsdp"
    with pytest.raises(ValueError, match="does not cover"):
        build_mesh("HYBRID_SHARD", fsdp_size=2)
    for axis in ("tp", "sp", "pp", "ep"):
        with pytest.raises(ValueError, match="not divisible"):  # one device, as in JAX
            build_mesh("NO_SHARD", **{f"{axis}_size": 2})


# name: (strategy, mesh kwargs, LOCAL_WORLD_SIZE) over two processes of one
# device each, and the (dp, fsdp) sizes or the start of the error
HOST_CASES = {
    "two hosts of one": ("HYBRID_SHARD", {}, 1, (2, 1)),
    "one host of two": ("HYBRID_SHARD_ZERO2", {}, 2, (1, 2)),
    "sizes given": ("HYBRID_SHARD", {"fsdp_size": 2}, None, (1, 2)),
    "host unknown": ("HYBRID_SHARD", {}, None, "HYBRID_SHARD over 2 processes shards within a host by default"),
}


@pytest.fixture(scope="module")
def host_meshes(tmp_path_factory):
    cases = {k: (s, kw, local) for k, (s, kw, local, _) in HOST_CASES.items()}
    return spawn("mesh", 2, {"cases": cases}, tmp_path_factory.mktemp("mesh"))


@pytest.mark.parametrize("case", list(HOST_CASES))
def test_hybrid_default_shards_within_a_host(host_meshes, case):
    """A hybrid strategy with neither size shards over one host's
    processes, as the JAX mesh shards over one process's devices: the
    count comes from torchrun's LOCAL_WORLD_SIZE (or the host's CUDA
    devices under NCCL); a gloo group launched without it (``--multihost``)
    must give a size, and is told so, rather than shard across hosts."""
    _, _, _, want = HOST_CASES[case]
    for got in host_meshes:
        if isinstance(want, str):
            assert got[case].startswith(want) and "--fsdp-size" in got[case]
        else:
            assert (got[case]["dp"], got[case]["fsdp"]) == want
            assert mesh_sizes(HOST_CASES[case][0], 2, local_count=HOST_CASES[case][2] or 2,
                              **HOST_CASES[case][1]) == got[case]


@pytest.mark.parametrize("strategy", list(STRATEGIES))
@pytest.mark.parametrize("for_params", [True, False], ids=["params", "optstate"])
def test_param_specs_match_jax(tiny_cfg, strategy, for_params):
    name, kw = STRATEGIES[strategy]
    jplan = jbuild_mesh(name, devices=jax.devices()[:4], **kw)
    got = tllama.flatten_params(param_specs(tiny_cfg, layout_plan(name, 4, **kw), for_params=for_params))
    want = [tuple(p) for p in jax.tree.leaves(jparam_specs(tiny_cfg, jplan, for_params=for_params),
                                               is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))]
    assert got == want


@pytest.mark.parametrize("strategy", list(STRATEGIES))
def test_optstate_specs_match_jax(tiny_cfg, strategy):
    """Each AdamW moment takes its param's optimizer-state spec. The JAX
    trainer looks the spec up by shape; that gives the same spec except
    where an earlier leaf of the same shape has another: q_proj, whose
    [L, 64, 64] shape is o_proj's at tiny_cfg. The port keeps a moment's
    blocks aligned with its param's."""
    name, kw = STRATEGIES[strategy]
    jt = JInnerTrainer(tiny_cfg, JTrainerConfig(**TC), jbuild_mesh(name, devices=jax.devices()[:4], **kw))
    want = [tuple(p) for p in jax.tree.leaves(jt.opt_specs[1][0].mu,
                                               is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))]
    plan = layout_plan(name, 4, **kw)
    got = optstate_specs(tiny_cfg, plan)
    assert got["mu"] == got["nu"] == tllama.flatten_params(param_specs(tiny_cfg, plan, for_params=False))
    shapes = tllama.flatten_params(tllama.shapes(tiny_cfg))
    by_shape: dict = {}
    for shape, spec in zip(shapes, got["mu"]):
        by_shape.setdefault(shape, spec)
    assert want == [by_shape[s] for s in shapes]
    paths = [p for p, _ in jax.tree_util.tree_flatten_with_path(tllama.shapes(tiny_cfg),
                                                                  is_leaf=lambda x: isinstance(x, tuple))[0]]
    differ = {jax.tree_util.keystr(p) for p, a, b in zip(paths, got["mu"], want) if a != b}
    assert differ == (set() if name == "NO_SHARD" else {"['layers']['q_proj']"})


@pytest.mark.parametrize("strategy", ["FULL_SHARD", "HYBRID_SHARD"])
def test_local_block_is_the_jax_shard(tiny_cfg, strategy):
    """Rank r's block of each cut leaf is JAX's shard on device r, and the
    blocks join back to the leaf."""
    name, kw = STRATEGIES[strategy]
    jplan = jbuild_mesh(name, devices=jax.devices()[:4], **kw)
    plan = layout_plan(name, 4, **kw)
    fsdp = plan.shape["fsdp"]
    specs = tllama.flatten_params(param_specs(tiny_cfg, plan))
    rng = np.random.default_rng(0)
    for shape, spec in zip(tllama.flatten_params(tllama.shapes(tiny_cfg)), specs):
        full = rng.standard_normal(shape).astype(np.float32)
        arr = jax.device_put(full, jplan.sharding(jax.sharding.PartitionSpec(*spec)))
        dim = spec_dim(spec)
        for shard in arr.addressable_shards:
            r = jax.devices().index(shard.device) % fsdp
            np.testing.assert_array_equal(local_block(full, dim, fsdp, r), np.asarray(shard.data))
        blocks = [local_block(full, dim, fsdp, r) for r in range(fsdp)]
        np.testing.assert_array_equal(join_blocks(blocks, dim), full)
        t = torch.from_numpy(full)
        assert torch.equal(join_blocks([local_block(t, dim, fsdp, r) for r in range(fsdp)], dim), t)


# ---------------------------------------------------------------------------
# the strategies over a gloo group of four processes
# ---------------------------------------------------------------------------


def _np_params(cfg, seed):
    rng = np.random.default_rng(seed)

    def draw(tree, name=""):
        if isinstance(tree, dict):
            return {k: draw(v, k) for k, v in tree.items()}
        base, scale = (1.0, 0.1) if "norm" in name else (0.0, 0.02)
        return (base + scale * rng.standard_normal(tree)).astype(np.float32)

    return draw(tllama.shapes(cfg))


def _batches(vocab: int):
    """Four ramp batches [16, 32] (accum 2: micro-batches of 8 rows, 2 a
    rank of four); the last has IGNORE labels on rank 1's rows alone."""
    rng = np.random.default_rng(7)
    out = []
    for i in range(4):
        starts = rng.integers(0, vocab, (16, 1))
        ids = ((starts + np.arange(32)) % vocab).astype(np.int32)
        labels = ids.copy()
        if i == 3:
            labels[2:4] = IGNORE  # micro-batch 0, rank 1's rows
            labels[10:12] = IGNORE  # micro-batch 1, rank 1's rows
        out.append((ids, labels))
    return out


def _eval_batch(vocab: int):
    """[8, 32]: rank 1 of four gets rows 2-3, all IGNORE."""
    ids = ((np.arange(8)[:, None] * 7 + np.arange(32)) % vocab).astype(np.int32)
    labels = ids.copy()
    labels[2:4] = IGNORE
    return ids, labels


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The strategies at four ranks and at one (hybrids at fsdp 1), the
    single-device trainer in this process, and the JAX trainer on four
    virtual devices, on the same params and batches."""
    from opendiloco_torch.models.llama import LlamaConfig

    cfg = LlamaConfig(**CFG)
    params = _np_params(cfg, 6)
    batches = _batches(cfg.vocab_size)
    ev = _eval_batch(cfg.vocab_size)
    cases = {**STRATEGIES, **KERNEL_PATH}
    spec = dict(cfg=CFG, params=params, batches=batches, eval=ev, tc=TC, accum=2, cases=cases)
    tmp = tmp_path_factory.mktemp("strategies")
    four = spawn("strategies", 4, spec, tmp)
    one_cases = {k: (s, {"fsdp_size": 1} if kw else {}, *tc) for k, (s, kw, *tc) in cases.items()}
    one = spawn("strategies", 1, {**spec, "cases": one_cases}, tmp)[0]

    def single(tc: dict) -> dict:
        trainer = InnerTrainer(cfg, TrainerConfig(**{**TC, **tc}), device="cpu")
        state = trainer.init_state(params=params)
        losses = []
        for ids, labels in batches:
            state, m = trainer.train_step(state, trainer.shard_batch(ids, labels, accum=2))
            losses.append(float(m["loss"]))
        return {"losses": losses, "params": [p.detach().numpy() for p in tllama.flatten_params(state["params"])],
                "mu": [m.numpy() for m in state["opt_state"]["mu"]], "nu": [v.numpy() for v in state["opt_state"]["nu"]],
                "eval": trainer.eval_loss(state["params"], *ev), "probe": trainer.probe_norms(state["params"], ev[0])}

    singles = {k: single(tc[0]) for k, (_, _, *tc) in KERNEL_PATH.items()}
    return {"four": four, "one": one, "single": single({}), "singles": singles, "cfg": cfg, "params": params,
            "batches": batches}


def _jax_run(tiny_cfg, strategy, kw, params, batches):
    jt = JInnerTrainer(tiny_cfg, JTrainerConfig(**TC), jbuild_mesh(strategy, devices=jax.devices()[:4], **kw))
    state = jt.init_state(jax.random.key(0), params)
    losses = []
    for ids, labels in batches:
        state, m = jt.train_step(state, jt.shard_batch(ids, labels, accum=2))
        losses.append(float(m["loss"]))
    return np.array(losses), [np.asarray(x) for x in jax.tree.leaves(jax.device_get(state["params"]))]


def _assert_moments_close(got: dict, want: dict) -> None:
    """The AdamW moments, gathered whole, against the single-device
    trainer's: each leaf within 1e-5 of its largest magnitude (the params'
    atol 1e-5 put on the moment's own scale, since nu is about g**2 and
    sits far below 1e-5), and rtol 1e-5. A block joined in the wrong order
    or along the wrong dim misses by the moments' own size."""
    for key in ("mu", "nu"):
        assert len(got[key]) == len(want[key])
        for i, (a, b) in enumerate(zip(got[key], want[key])):
            assert a.shape == b.shape, (key, i)
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * float(np.abs(b).max()), err_msg=f"{key}[{i}]")


@pytest.mark.parametrize("strategy", list(STRATEGIES))
def test_four_ranks_match_one_rank_and_jax(runs, tiny_cfg, strategy):
    """The 4-step trajectory of every strategy at four ranks: every rank
    reports the same losses, which equal the single-device port's and the
    JAX trainer's on four virtual devices, as do the final params; the
    whole state that ``gather_state`` hands a checkpoint (params and AdamW
    moments) equals the single-device trainer's."""
    got = runs["four"][0][strategy]
    for r in runs["four"][1:]:
        assert r[strategy]["losses"] == got["losses"] and r[strategy]["norms"] == got["norms"]
    single = runs["single"]
    np.testing.assert_allclose(got["losses"], single["losses"], rtol=1e-5)
    for a, b in zip(got["params"], single["params"]):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
    _assert_moments_close(got, single)
    name, kw = STRATEGIES[strategy]
    jlosses, jparams = _jax_run(tiny_cfg, name, kw, runs["params"], runs["batches"])
    np.testing.assert_allclose(got["losses"], jlosses, rtol=1e-5)
    for a, b in zip(got["params"], jparams):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)


@pytest.mark.parametrize("case", list(KERNEL_PATH))
def test_four_ranks_on_the_kernel_path_match_one_device(runs, case):
    """Remat (each layer gathered again on recompute), the flash-attention
    and fused-loss entries (their plain versions here) at four ranks."""
    got, single = runs["four"][0][case], runs["singles"][case]
    assert all(r[case]["losses"] == got["losses"] for r in runs["four"])
    np.testing.assert_allclose(got["losses"], single["losses"], rtol=1e-5)
    for a, b in zip(got["params"], single["params"]):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
    _assert_moments_close(got, single)
    assert got["eval"] == pytest.approx(single["eval"], rel=1e-5)


@pytest.mark.parametrize("strategy", [*STRATEGIES, *KERNEL_PATH])
def test_one_rank_is_the_single_device_trainer_bit_for_bit(runs, strategy):
    got, single = runs["one"][strategy], runs["singles"].get(strategy, runs["single"])
    assert got["losses"] == single["losses"]
    for key in ("params", "mu", "nu"):
        for a, b in zip(got[key], single[key]):
            np.testing.assert_array_equal(a, b)


def test_full_shard_holds_a_quarter_of_each_cut_leaf(runs):
    """FULL_SHARD: each rank holds 1/4 of every cut leaf and of its AdamW
    moments; replicated leaves (the norms) whole."""
    cfg = runs["cfg"]
    full = tllama.flatten_params(tllama.shapes(cfg))
    dims = [spec_dim(s) for s in tllama.flatten_params(param_specs(cfg, layout_plan("FULL_SHARD", 4)))]
    assert any(d is not None for d in dims) and any(d is None for d in dims)
    for r in runs["four"]:
        shapes = r["FULL_SHARD"]["shapes"]
        for shape, dim, p, mu in zip(full, dims, shapes["params"], shapes["mu"]):
            want = list(shape)
            if dim is not None:
                want[dim] //= 4
            assert list(p) == list(mu) == want


def test_zero2_params_whole_and_optstate_cut(runs):
    cfg = runs["cfg"]
    full = tllama.flatten_params(tllama.shapes(cfg))
    for strategy, n in (("SHARD_GRAD_OP", 4), ("HYBRID_SHARD_ZERO2", 2)):
        dims = [spec_dim(s) for s in tllama.flatten_params(
            param_specs(cfg, layout_plan(strategy, 4, **STRATEGIES[strategy][1]), for_params=False))]
        for r in runs["four"]:
            shapes = r[strategy]["shapes"]
            assert [tuple(p) for p in shapes["params"]] == [tuple(s) for s in full]
            for shape, dim, mu in zip(full, dims, shapes["mu"]):
                want = list(shape)
                if dim is not None:
                    want[dim] //= n
                assert list(mu) == want
            assert shapes["mu"] != shapes["params"]


@pytest.mark.parametrize("strategy", list(STRATEGIES))
def test_masked_rows_on_one_rank_give_the_global_mean(runs, strategy):
    """Rank 1's eval rows are all IGNORE: the loss is the mean over the
    whole batch's counted tokens (a mean of the ranks' means would differ),
    and the probes are norms over the whole batch."""
    got, single = runs["four"][0][strategy], runs["single"]
    assert got["eval"] == pytest.approx(single["eval"], rel=1e-5)
    assert got["probe"].keys() == single["probe"].keys()
    for k in got["probe"]:
        assert got["probe"][k] == pytest.approx(single["probe"][k], rel=1e-5)


def test_sharded_fused_loss_entry_equals_the_unsharded(tmp_path):
    """The fused lm-head + cross-entropy over four ranks' rows (D 128, the
    kernel path's plain versions): the whole batch's mean, each rank's
    hidden gradient its rows', and the head's gradient summed over the
    ranks equal the unsharded entry's."""
    from opendiloco_torch.ops.fused_xent import fused_linear_cross_entropy, fused_linear_cross_entropy_sharded

    rng = np.random.default_rng(3)
    h = rng.standard_normal((64, 128)).astype(np.float32)
    w = (0.05 * rng.standard_normal((128, 512))).astype(np.float32)
    labels = rng.integers(0, 512, 64)
    labels[16:32] = IGNORE  # rank 1's rows
    labels[40:44] = IGNORE
    ranks = spawn("fused", 4, {"hwl": (h, w, labels)}, tmp_path)
    th, tw = torch.from_numpy(h).requires_grad_(True), torch.from_numpy(w).requires_grad_(True)
    loss = fused_linear_cross_entropy(th, tw, torch.from_numpy(labels))
    loss.backward()
    for r in ranks:
        assert r["loss"] == pytest.approx(float(loss.detach()), rel=1e-6)
    np.testing.assert_allclose(np.concatenate([r["dh"] for r in ranks]), th.grad.numpy(), atol=1e-7, rtol=1e-5)
    np.testing.assert_allclose(sum(r["dw"] for r in ranks), tw.grad.numpy(), atol=1e-7, rtol=1e-5)
    # without a group, the sharded entry is the unsharded one
    assert torch.equal(fused_linear_cross_entropy_sharded(th, tw, torch.from_numpy(labels), mesh=None), loss)
    # and a tp axis without a mesh takes the head as it is
    assert torch.equal(fused_linear_cross_entropy_sharded(th, tw, torch.from_numpy(labels), mesh=None,
                                                          tp_axis="tp"), loss)
