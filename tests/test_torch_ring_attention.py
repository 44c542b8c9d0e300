"""Ring attention and sequence parallelism of the port against the JAX
package, on the CPU.

- Both ring bodies of ``opendiloco_torch/ops/ring_attention.py`` on a
  loopback ring of 2 and 4 ranks (threads) against JAX
  ``ring_attention_auto`` on as many virtual devices: the einsum ring,
  and the flash-chunk ring with ``OPENDILOCO_TPU_RING_FLASH=1`` and the
  JAX kernels in interpret mode (the port's flash ring runs the kernels'
  plain versions here). Out and the q, k, v gradients of sum(out * w),
  GQA (4 q heads over 2 kv heads).
- The ``torch.distributed`` ring over gloo ranks equals the loopback ring
  bit for bit (both run in one child process, on one thread).
- ``InnerTrainer`` with sp 2 and sp 4 (and sp beside dp and fsdp) over
  gloo ranks against the port at sp 1 and the JAX trainer on as many
  virtual devices (sp 2 beside ep 2 is in ``tests/test_torch_moe.py``):
  through the ring (``attn_impl`` "auto"), and through the gather, where
  "xla" and "pallas" attend over the whole sequence on every rank (the
  JAX "pallas" trainer with its kernels in interpret mode).
- The same trainer over rank threads of one process
  (``parallel/mesh.py loopback_plans(sp_size=...)``, the path over one
  card) against the gloo run and sp 1, ring and gather, sp 2 alone and
  beside tp 2.

Tolerances, each with its reason:
- f32 rings: out atol 2e-5, gradients atol 3e-5 of their largest
  magnitude (at least 1), the JAX package's own ring tests': the chunks
  merge their softmax statistics in another order than one pass does.
- bf16 rings: out atol 2e-2, gradients 4e-2 of their largest magnitude,
  the JAX bf16 ring tests': bf16 rounds p, ds and the outputs, in other
  places in the two frameworks' einsums and kernels.
- trainer trajectories: loss rtol 1e-5, params atol 1e-5, as
  ``tests/test_torch_parallel.py``: ranks and frameworks re-associate the
  f32 gradient sums.
"""
import threading

import jax
import numpy as np
import pytest
import torch

from opendiloco_tpu.ops import ring_attention as jra
from opendiloco_tpu.parallel.mesh import build_mesh as jbuild_mesh
from opendiloco_tpu.trainer import InnerTrainer as JInnerTrainer
from opendiloco_tpu.trainer import TrainerConfig as JTrainerConfig
from opendiloco_torch.models import llama as tllama
from opendiloco_torch.models.convert import params_from_numpy
from opendiloco_torch.ops import ring_attention as ra
from opendiloco_torch.ops.flash_attention import flash_attention
from opendiloco_torch.parallel.comm import LoopbackGroup
from opendiloco_torch.parallel.mesh import layout_plan, loopback_plans
from opendiloco_torch.trainer import InnerTrainer, TrainerConfig, _resolve_perf_defaults
from torch_dist_child import spawn

torch.set_num_threads(2)

CFG = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
           num_key_value_heads=2, max_position_embeddings=128)
TC = dict(lr=1e-3, warmup_steps=2, total_steps=100, precision="fp32", remat=False)
# name: (strategy, mesh kwargs, world, TrainerConfig overrides)
SP = {
    "sp2": ("NO_SHARD", {"sp_size": 2}, 2, {}),
    "sp4": ("NO_SHARD", {"sp_size": 4}, 4, {}),
    "dp2_sp2": ("NO_SHARD", {"sp_size": 2}, 4, {}),
    "fsdp2_sp2": ("FULL_SHARD", {"sp_size": 2}, 4, {}),
    "sp2_remat_fused": ("NO_SHARD", {"sp_size": 2}, 2, {"remat": True, "fused_loss": True}),
    # the gather: every rank attends over the whole sequence
    "sp2_xla": ("NO_SHARD", {"sp_size": 2}, 2, {"attn_impl": "xla"}),
    "sp4_xla": ("NO_SHARD", {"sp_size": 4}, 4, {"attn_impl": "xla"}),
    "dp2_sp2_xla": ("NO_SHARD", {"sp_size": 2}, 4, {"attn_impl": "xla"}),
    "fsdp2_sp2_xla": ("FULL_SHARD", {"sp_size": 2}, 4, {"attn_impl": "xla"}),
    "sp2_pallas_remat_fused": ("NO_SHARD", {"sp_size": 2}, 2, {"attn_impl": "pallas", "remat": True,
                                                                "fused_loss": True}),
}
# held against the port alone: the ring's kernel path with the fused loss
PORT_ONLY = ("sp2_remat_fused",)
B, T, H, HKV, D = 1, 512, 4, 2, 64  # T/4 = 128 rows a chunk: the JAX flash ring's tile


def _qkvw(seed: int = 7):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, T, H, D)).astype(np.float32)
    k = rng.normal(size=(B, T, HKV, D)).astype(np.float32)
    v = rng.normal(size=(B, T, HKV, D)).astype(np.float32)
    w = rng.normal(size=(B, T, H, D)).astype(np.float32)
    return (q, k, v), w


def _loopback(fn, qkv, w, n: int, dtype) -> list:
    """fn on a loopback ring of n ranks, one thread each: [out, dq, dk, dv]
    over the whole sequence, f32 numpy."""
    ring, tl = LoopbackGroup(n), T // n
    res: list = [None] * n
    errors: list = []

    def run(r):
        try:
            cut = slice(r * tl, (r + 1) * tl)
            q, k, v = (torch.from_numpy(a[:, cut].copy()).to(dtype).requires_grad_(True) for a in qkv)
            o = fn(q, k, v, ring.rank(r))
            (o.float() * torch.from_numpy(w[:, cut].copy())).sum().backward()
            res[r] = [t.detach().float().numpy() for t in (o, q.grad, k.grad, v.grad)]
        except Exception as e:  # pragma: no cover - surfaced below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    return [np.concatenate([x[i] for x in res], axis=1) for i in range(4)]


def _jax_ring(qkv, w, n: int, dtype) -> list:
    import jax.numpy as jnp

    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:n]).reshape(1, 1, n, 1), ("dp", "fsdp", "sp", "tp"))
    jdtype = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16}.get(dtype, jnp.float32)
    q, k, v = (jnp.asarray(a, jdtype) for a in qkv)

    def loss(q, k, v):
        o = jra.ring_attention_auto(q, k, v, mesh=mesh, axis="sp")
        return jnp.sum(o.astype(jnp.float32) * w), o

    (_, o), g = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    return [np.asarray(x, np.float32) for x in (o, *g)]


def _assert_ring_close(got: list, want: list, dtype) -> None:
    # f16 keeps 3 more mantissa bits than bf16: its tolerances are bf16's / 8
    atol_out, rel_grad = {torch.bfloat16: (2e-2, 4e-2), torch.float16: (2.5e-3, 5e-3)}.get(dtype, (2e-5, 3e-5))
    np.testing.assert_allclose(got[0], want[0], atol=atol_out, rtol=0)
    for name, a, b in zip("qkv", got[1:], want[1:]):
        np.testing.assert_allclose(a, b, atol=rel_grad * max(float(np.abs(b).max()), 1.0), rtol=0, err_msg=f"d{name}")


@pytest.fixture
def interpret_pallas(monkeypatch):
    """The JAX flash kernels in interpreter mode, and the JAX ring on its
    flash-chunk path."""
    import jax.experimental.pallas as pl

    from opendiloco_tpu.ops import flash_attention as fa

    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(fa.pl, "pallas_call", patched)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n", [2, 4])
def test_einsum_ring_matches_jax_ring(n, dtype, monkeypatch):
    monkeypatch.setenv("OPENDILOCO_TPU_RING_FLASH", "0")
    qkv, w = _qkvw()
    _assert_ring_close(_loopback(ra.ring_attention, qkv, w, n, dtype), _jax_ring(qkv, w, n, dtype), dtype)


@pytest.mark.parametrize("n,dtype", [(2, torch.float32), (2, torch.bfloat16), (4, torch.float32), (4, torch.bfloat16),
                                     (2, torch.float16)], ids=["2-f32", "2-bf16", "4-f32", "4-bf16", "2-f16"])
def test_flash_ring_matches_jax_flash_ring(interpret_pallas, n, dtype, monkeypatch):
    monkeypatch.setenv("OPENDILOCO_TPU_RING_FLASH", "1")
    qkv, w = _qkvw()
    _assert_ring_close(_loopback(ra.ring_flash_attention, qkv, w, n, dtype), _jax_ring(qkv, w, n, dtype), dtype)


@pytest.mark.parametrize("n", [2, 4])
def test_flash_ring_matches_the_einsum_ring(n):
    """The port's two bodies on the same loopback ring (f32)."""
    qkv, w = _qkvw(3)
    _assert_ring_close(_loopback(ra.ring_flash_attention, qkv, w, n, torch.float32),
                       _loopback(ra.ring_attention, qkv, w, n, torch.float32), torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_ring_of_one_rank_is_flash_attention_bit_for_bit(dtype):
    """At sp 1 the flash ring is one causal chunk: out and gradients equal
    flash_attention's (its f32 gradients cast to the input dtype are the
    plain version's own)."""
    (q, k, v), w = _qkvw(5)
    res = []
    for fn in (lambda q, k, v: ra.ring_flash_attention(q, k, v), lambda q, k, v: flash_attention(q, k, v)):
        tq, tk, tv = (torch.from_numpy(a).to(dtype).requires_grad_(True) for a in (q, k, v))
        o = fn(tq, tk, tv)
        (o.float() * torch.from_numpy(w)).sum().backward()
        res.append([o.detach(), tq.grad, tk.grad, tv.grad])
    for a, b in zip(*res):
        assert torch.equal(a, b)


def test_model_ring_at_sp1_equals_pallas_bit_for_bit():
    cfg = tllama.LlamaConfig(**CFG)
    rng = np.random.default_rng(1)
    params = params_from_numpy(_np_params(cfg, 2))
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 64)))
    outs = [tllama.forward(params, ids, cfg, compute_dtype=torch.bfloat16, attn_impl=impl, remat=True)
            for impl in ("ring", "pallas")]
    assert torch.equal(outs[0], outs[1])


def test_auto_resolves_to_ring_under_sp_and_explicit_attention_gathers():
    """Under sp "auto" takes the ring and an explicit "xla" or "pallas"
    passes through (the gather), the fused loss off unless asked for, on
    both devices; a trainer at sp 2 with "xla" builds."""
    cfg = tllama.LlamaConfig(**CFG)
    plan = layout_plan("NO_SHARD", 2, sp_size=2)
    for device in ("cpu", "cuda"):
        tc = _resolve_perf_defaults(TrainerConfig(), cfg, torch.device(device), plan)
        assert (tc.attn_impl, tc.fused_loss) == ("ring", False)
        for impl in ("xla", "pallas"):
            tc = _resolve_perf_defaults(TrainerConfig(attn_impl=impl), cfg, torch.device(device), plan)
            assert (tc.attn_impl, tc.fused_loss) == (impl, False)
    assert _resolve_perf_defaults(TrainerConfig(attn_impl="ring"), cfg, torch.device("cpu")).attn_impl == "ring"
    tr = InnerTrainer(cfg, TrainerConfig(attn_impl="xla"), device="cpu", plan=plan)
    assert (tr.tc.attn_impl, tr.tc.fused_loss) == ("xla", False)


# ---------------------------------------------------------------------------
# gloo ranks: the dist ring and the trainer
# ---------------------------------------------------------------------------


def _np_params(cfg, seed):
    rng = np.random.default_rng(seed)

    def draw(tree, name=""):
        if isinstance(tree, dict):
            return {k: draw(v, k) for k, v in tree.items()}
        base, scale = (1.0, 0.1) if "norm" in name else (0.0, 0.02)
        return (base + scale * rng.standard_normal(tree)).astype(np.float32)

    return draw(tllama.shapes(cfg))


def _batches(vocab: int, n: int = 3):
    rng = np.random.default_rng(11)
    out = []
    for _ in range(n):
        ids = ((rng.integers(0, vocab, (8, 1)) + np.arange(32)) % vocab).astype(np.int32)
        labels = ids.copy()
        labels[1, 7:12] = -100  # ignored targets, on some sp ranks' chunks
        out.append((ids, labels))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One launch a world size: the dist ring against the loopback ring in
    one child, and the SP cases; the single-device port in this process."""
    cfg = tllama.LlamaConfig(**CFG)
    params = _np_params(cfg, 6)
    batches = _batches(cfg.vocab_size)
    qkv, w = _qkvw(9)
    tmp = tmp_path_factory.mktemp("ring")
    out = {}
    for world in (2, 4):
        cases = {k: (s, kw, tc) for k, (s, kw, wd, tc) in SP.items() if wd == world}
        strat = dict(cfg=CFG, params=params, batches=batches, eval=batches[0], tc=TC, accum=2, cases=cases)
        jobs = [("ring", dict(qkv=qkv, w=w, dtype=dt)) for dt in ("float32", "bfloat16")] + [("strategies", strat)]
        out[world] = spawn("many", world, {"jobs": jobs}, tmp)

    def single(tc: dict) -> dict:
        trainer = InnerTrainer(cfg, TrainerConfig(**{**TC, **tc}), device="cpu")
        state = trainer.init_state(params=params)
        losses = []
        for ids, labels in batches:
            state, m = trainer.train_step(state, trainer.shard_batch(ids, labels, accum=2))
            losses.append(float(m["loss"]))
        return {"losses": losses, "params": [p.detach().numpy() for p in tllama.flatten_params(state["params"])],
                "eval": trainer.eval_loss(state["params"], *batches[0]),
                "probe": trainer.probe_norms(state["params"], batches[0][0])}

    singles = {k: single(tc) for k, (*_, tc) in SP.items()}
    return {"ranks": out, "singles": singles, "cfg": cfg, "params": params, "batches": batches, "qkvw": (qkv, w)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("world", [2, 4])
def test_dist_ring_equals_the_loopback_ring_bit_for_bit(runs, world, dtype):
    """Each gloo rank's chunk of out and of the gradients equals the
    loopback ring's in the same child process, both bodies, bit for bit;
    and the loopback ring there is the one this process runs (within the
    f32 or bf16 ring tolerance: another thread count may re-associate)."""
    qkv, w = runs["qkvw"]
    ranks = runs["ranks"][world]
    job = ["float32", "bfloat16"].index(dtype)
    for name, fn in (("flash", ra.ring_flash_attention), ("einsum", ra.ring_attention)):
        loop = ranks[0][job]["loopback"][name]
        for r, res in enumerate(ranks):
            for a, b in zip(res[job][name], loop[r]):
                np.testing.assert_array_equal(a, b, err_msg=f"{name} rank {r}")
        got = [np.concatenate([x[i] for x in loop], axis=1) for i in range(4)]
        _assert_ring_close(got, _loopback(fn, qkv, w, world, getattr(torch, dtype)), getattr(torch, dtype))


def _jax_run(cfg, strategy, kw, world, tc, params, batches):
    jt = JInnerTrainer(cfg, JTrainerConfig(**{**TC, **tc}), jbuild_mesh(strategy, devices=jax.devices()[:world], **kw))
    state = jt.init_state(jax.random.key(0), params)
    losses = []
    for ids, labels in batches:
        state, m = jt.train_step(state, jt.shard_batch(ids, labels, accum=2))
        losses.append(float(m["loss"]))
    return np.array(losses), [np.asarray(x) for x in jax.tree.leaves(jax.device_get(state["params"]))]


@pytest.mark.parametrize("case", list(SP))
def test_sequence_parallel_trainer_matches_sp1_and_jax(runs, case, request):
    """Every rank reports the same losses, which equal the port's at sp 1
    and the JAX trainer's on as many virtual devices with the same
    ``attn_impl`` (its ring under "auto"), as do the final params, the
    eval loss over the chunks and the activation probes."""
    strategy, kw, world, tc = SP[case]
    ranks = [r[-1][case] for r in runs["ranks"][world]]
    got, single = ranks[0], runs["singles"][case]
    assert all(r["losses"] == got["losses"] for r in ranks)
    np.testing.assert_allclose(got["losses"], single["losses"], rtol=1e-5)
    for a, b in zip(got["params"], single["params"]):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
    assert got["eval"] == pytest.approx(single["eval"], rel=1e-5)
    for k, v in single["probe"].items():
        assert got["probe"][k] == pytest.approx(v, rel=1e-5), k
    if case in PORT_ONLY:
        return
    if tc.get("attn_impl") == "pallas":
        request.getfixturevalue("interpret_pallas")
        request.getfixturevalue("interpret_pallas_fused")
    jlosses, jparams = _jax_run(runs["cfg"], strategy, kw, world, tc, runs["params"], runs["batches"])
    np.testing.assert_allclose(got["losses"], jlosses, rtol=1e-5)
    for a, b in zip(got["params"], jparams):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# rank threads of one process: the path over one card
# ---------------------------------------------------------------------------


def _rank_threads(plans: list, fn) -> list:
    """fn(plan) on one thread a plan, each running its backward on its own
    thread (as on the card, where the ranks wait on each other inside
    backward nodes); a failing rank aborts the others' comms."""
    out, errors = [None] * len(plans), []

    def one(r):
        try:
            with torch.autograd.set_multithreading_enabled(False):
                out[r] = fn(plans[r])
        except BaseException as e:  # pragma: no cover - re-raised below
            errors.append(e)
            for plan in plans:
                for c in plan.comms.values():
                    c.g.abort()

    threads = [threading.Thread(target=one, args=(r,)) for r in range(len(plans))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors, errors
    return out


def _train_run(cfg, plan, tc: dict, params, batches) -> dict:
    """The SP cases' run on one rank: losses and grad norms a step, the
    whole params after the last (a collective), the eval loss and probes
    of the first batch."""
    trainer = InnerTrainer(cfg, TrainerConfig(**{**TC, **tc}), device="cpu", plan=plan)
    state = trainer.init_state(params=params)
    losses, norms = [], []
    for ids, labels in batches:
        state, m = trainer.train_step(state, trainer.shard_batch(ids, labels, accum=2))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return {"losses": losses, "norms": norms, "params": trainer.host_params(tllama.flatten_params(state["params"])),
            "eval": trainer.eval_loss(state["params"], *batches[0]),
            "probe": trainer.probe_norms(state["params"], batches[0][0])}


# name: (loopback_plans sizes, the gloo SP case of the same attention)
THREADS = {
    "sp2 ring": ({"sp_size": 2}, "sp2"),
    "sp2 xla": ({"sp_size": 2}, "sp2_xla"),
    "sp2 tp2 ring": ({"sp_size": 2, "tp_size": 2}, "sp2"),
    "sp2 tp2 xla": ({"sp_size": 2, "tp_size": 2}, "sp2_xla"),
}


@pytest.mark.parametrize("case", list(THREADS))
def test_rank_thread_sp_matches_gloo_and_sp1(runs, case):
    """``loopback_plans`` rank threads at sp 2 (beside tp 2): every thread's
    losses, grad norms, params, eval loss and probes are the same bits,
    and they equal the gloo ranks' of the same attention and the port's at
    sp 1 at the f32 trajectory bounds."""
    sizes, gloo_case = THREADS[case]
    tc = SP[gloo_case][3]
    got = _rank_threads(loopback_plans(**sizes),
                        lambda plan: _train_run(runs["cfg"], plan, tc, runs["params"], runs["batches"]))
    for other in got[1:]:
        assert (other["losses"], other["norms"], other["eval"], other["probe"]) == (
            got[0]["losses"], got[0]["norms"], got[0]["eval"], got[0]["probe"])
        for a, b in zip(other["params"], got[0]["params"]):
            np.testing.assert_array_equal(a, b)
    for want in (runs["ranks"][2][0][-1][gloo_case], runs["singles"][gloo_case]):
        np.testing.assert_allclose(got[0]["losses"], want["losses"], rtol=1e-5)
        for a, b in zip(got[0]["params"], want["params"]):
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
        assert got[0]["eval"] == pytest.approx(want["eval"], rel=1e-5)
        for k, v in want["probe"].items():
            assert got[0]["probe"][k] == pytest.approx(v, rel=1e-5), k


@pytest.mark.parametrize("impl", ["ring", "xla"])
def test_rank_thread_sp_sums_over_the_data_group(runs, impl):
    """Rank threads at sp 2 sum the loss's sum and count, the gradients,
    the eval loss and the probes' squares over their sp comm: on a batch
    whose targets past position 20 are ignored, rank 0 counts 16 targets
    a row and rank 1 three, so a rank that divided by its own count, or
    stepped on its own chunk's gradient, would leave sp 1's loss and
    params; both ranks match them."""
    cfg, params = runs["cfg"], runs["params"]
    ids, labels = runs["batches"][0]
    labels = labels.copy()
    labels[:, 20:] = -100
    batches = [(ids, labels)] * 2
    tc = {"attn_impl": impl}
    want = _train_run(cfg, layout_plan(), tc, params, batches)
    got = _rank_threads(loopback_plans(sp_size=2), lambda plan: _train_run(cfg, plan, tc, params, batches))
    for r in got:
        np.testing.assert_allclose(r["losses"], want["losses"], rtol=1e-5)
        np.testing.assert_allclose(r["norms"], want["norms"], rtol=1e-5)
        for a, b in zip(r["params"], want["params"]):
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
        assert r["eval"] == pytest.approx(want["eval"], rel=1e-5)
        for k, v in want["probe"].items():
            assert r["probe"][k] == pytest.approx(v, rel=1e-5), k
