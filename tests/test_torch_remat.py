"""The rematerialization policies of the port against ``remat=True`` and
against the JAX package, on the CPU, in f32.

Every policy of ``tests/test_model.py::test_remat_policies_forward_and_grad_parity``
(False, True, "none", "full", "dots", "dots_all") is a choice of what to
keep and what to rerun, never of what to compute: the port's loss and
whole gradients equal ``remat=True``'s bit for bit (the rerun ops are
deterministic and the kept outputs are the first run's). Against the JAX
package's same policy the bounds are those of ``tests/test_torch_train.py``
and ``tests/test_torch_pipeline.py``: both sides compute in f32 and differ
only in the order of their sums, so losses and grad norms rtol 1e-5, a
step's params atol 1e-6 (lr-sized AdamW updates), pp's atol 1e-5 after its
steps; the MoE gradients' atol 1e-4 is the MoE tests' bound. The flash
forward's plain version is counted: under "dots" the policy keeps B1's
out and lse (the custom op ``odtp::flash_fwd``), so it runs once a layer
as under False, and twice under True.
"""
import jax
import numpy as np
import pytest
import torch

from opendiloco_tpu.models import llama as jllama
from opendiloco_tpu.parallel.mesh import build_mesh as jbuild_mesh
from opendiloco_tpu.trainer import InnerTrainer as JInnerTrainer
from opendiloco_tpu.trainer import TrainerConfig as JTrainerConfig
from opendiloco_torch.models import llama as tllama
from opendiloco_torch.models.convert import params_from_numpy, params_to_numpy
from opendiloco_torch.ops import flash_attention as tfa
from opendiloco_torch.trainer import InnerTrainer, TrainerConfig
from torch_dist_child import spawn

torch.set_num_threads(2)

POLICIES = [False, True, "none", "full", "dots", "dots_all"]
MOE_CFG = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
               num_key_value_heads=2, max_position_embeddings=128, num_experts=4, expert_capacity_factor=1.25)
PP_CFG = dict(MOE_CFG, num_hidden_layers=4, num_experts=0)
TC = dict(lr=1e-3, warmup_steps=2, total_steps=50, precision="fp32")


def _np_params(cfg, seed):
    rng = np.random.default_rng(seed)

    def draw(tree, name=""):
        if isinstance(tree, dict):
            return {k: draw(v, k) for k, v in tree.items()}
        base, scale = (1.0, 0.1) if "norm" in name else (0.0, 0.05)
        return (base + scale * rng.standard_normal(tree)).astype(np.float32)

    return draw(tllama.shapes(cfg))


def _ids(cfg, n=2, t=32, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (n, t)).astype(np.int32)


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


@pytest.fixture
def flash_fwd_calls(monkeypatch):
    """A counter on the plain flash forward (B1's CPU body)."""
    calls = [0]
    plain = tfa.flash_attention_fwd_plain

    def counted(*args, **kw):
        calls[0] += 1
        return plain(*args, **kw)

    monkeypatch.setattr(tfa, "flash_attention_fwd_plain", counted)
    return calls


def _loss_and_grads(cfg, params, ids, remat, attn_impl):
    tparams = params_from_numpy(params, requires_grad=True)
    ids_t = torch.from_numpy(ids).long()
    logits, aux = tllama.forward(tparams, ids_t, cfg, compute_dtype=torch.float32, attn_impl=attn_impl,
                                 remat=remat, return_moe_aux=True)
    loss = tllama.causal_lm_loss(logits, ids_t)
    if cfg.num_experts:
        loss = loss + 0.01 * aux
    grads = torch.autograd.grad(loss, tllama.flatten_params(tparams))
    return loss.detach(), [g.detach() for g in grads]


@pytest.mark.parametrize("remat", POLICIES, ids=str)
@pytest.mark.parametrize("attn_impl,model", [("pallas", "dense"), ("xla", "dense"), ("xla", "moe")])
def test_policy_equals_full_remat_bit_for_bit(tiny_cfg, flash_fwd_calls, remat, attn_impl, model):
    cfg = tllama.LlamaConfig(**MOE_CFG) if model == "moe" else tllama.LlamaConfig.from_dict(tiny_cfg.to_dict())
    params, ids = _np_params(cfg, 1), _ids(cfg)
    ref_loss, ref_grads = _loss_and_grads(cfg, params, ids, True, attn_impl)
    ref_calls = flash_fwd_calls[0]
    flash_fwd_calls[0] = 0
    loss, grads = _loss_and_grads(cfg, params, ids, remat, attn_impl)
    assert torch.equal(loss, ref_loss)
    for a, b in zip(grads, ref_grads):
        assert torch.equal(a, b)
    L = cfg.num_hidden_layers
    if attn_impl == "pallas":
        assert ref_calls == 2 * L  # True reruns the forward, B1 with it
        assert flash_fwd_calls[0] == (2 * L if remat in (True, "full") else L)
    else:
        assert flash_fwd_calls[0] == ref_calls == 0


def _trainers(cfg, remat, attn_impl):
    tc = dict(TC, remat=remat, attn_impl=attn_impl)
    jt = JInnerTrainer(cfg, JTrainerConfig(**tc), jbuild_mesh("NO_SHARD", devices=[jax.devices()[0]]))
    tt = InnerTrainer(tllama.LlamaConfig.from_dict(cfg.to_dict()), TrainerConfig(**tc), device="cpu")
    return jt, tt


@pytest.mark.parametrize("remat", POLICIES, ids=str)
def test_policy_steps_match_jax(interpret_pallas, tiny_cfg, remat):
    """Two inner steps (accum 2) through the flash attention under each
    policy, the JAX side's kernels in interpret mode."""
    params = _np_params(tiny_cfg, 2)
    jt, tt = _trainers(tiny_cfg, remat, "pallas")
    js, ts = jt.init_state(jax.random.key(0), params), tt.init_state(params=params)
    for seed in range(2):
        ids = _ids(tiny_cfg, n=4, t=32, seed=seed)
        js, jm = jt.train_step(js, jt.shard_batch(ids, ids.copy(), accum=2))
        ts, tm = tt.train_step(ts, tt.shard_batch(ids, ids.copy(), accum=2))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
    for a, b in zip(jax.tree.leaves(jax.device_get(js["params"])),
                    tllama.flatten_params(params_to_numpy(ts["params"]))):
        np.testing.assert_allclose(b, np.asarray(a), atol=1e-6, rtol=0)


@pytest.mark.parametrize("remat", ["dots", "dots_all"])
def test_moe_policy_grads_match_jax(remat):
    """The routed experts' einsum dispatch (a batched product, kept under
    "dots_all") under each selective policy: loss and whole gradients
    against the JAX package's same policy."""
    cfg = tllama.LlamaConfig(**MOE_CFG)
    jcfg = jllama.LlamaConfig(**MOE_CFG)
    params, ids = _np_params(cfg, 3), _ids(cfg, seed=4)

    def jloss(p):
        logits, aux = jllama.forward(p, jax.numpy.asarray(ids), jcfg, compute_dtype=jax.numpy.float32,
                                     attn_impl="xla", remat=remat, return_moe_aux=True)
        return jllama.causal_lm_loss(logits, jax.numpy.asarray(ids)) + 0.01 * aux

    jl, jg = jax.value_and_grad(jloss)(params)
    tl, tg = _loss_and_grads(cfg, params, ids, remat, "xla")
    np.testing.assert_allclose(float(tl), float(jl), atol=2e-5, rtol=0)
    for a, b in zip(jax.tree.leaves(jg), tg):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-4, rtol=0)


def test_pipeline_policies_match_jax_and_full_remat(tmp_path):
    """pp 2 over two gloo ranks: three steps under "dots", "dots_all" and
    True on the same numpy params and batches; the selective policies equal
    True bit for bit (losses, grad norms, whole params) and the JAX
    pipeline's same policy within the pipeline tests' bounds."""
    cfg = tllama.LlamaConfig(**PP_CFG)
    params = _np_params(cfg, 5)
    batches = [(ids, ids.copy()) for ids in (_ids(cfg, n=8, seed=s) for s in range(3))]
    cases = {str(r): ("NO_SHARD", {"pp_size": 2}, {"remat": r}) for r in (True, "dots", "dots_all")}
    spec = dict(cfg=PP_CFG, params=params, batches=batches, eval=batches[0], tc={**TC, "attn_impl": "pallas"},
                accum=1, cases=cases)
    got = spawn("strategies", 2, spec, tmp_path, timeout=240)[0]
    for remat in ("dots", "dots_all"):
        assert got[remat]["losses"] == got["True"]["losses"]
        assert got[remat]["norms"] == got["True"]["norms"]
        for a, b in zip(got[remat]["params"], got["True"]["params"]):
            np.testing.assert_array_equal(a, b)
        jt = JInnerTrainer(jllama.LlamaConfig(**PP_CFG), JTrainerConfig(**TC, remat=remat, attn_impl="xla"),
                           jbuild_mesh("NO_SHARD", devices=jax.devices()[:2], pp_size=2))
        js = jt.init_state(jax.random.key(0), params)
        jlosses = []
        for ids, labels in batches:
            js, jm = jt.train_step(js, jt.shard_batch(ids, labels, accum=1))
            jlosses.append(float(jm["loss"]))
        np.testing.assert_allclose(got[remat]["losses"], jlosses, atol=2e-5, rtol=1e-5)
        for a, b in zip(jax.tree.leaves(jax.device_get(js["params"])), got[remat]["params"]):
            np.testing.assert_allclose(b, np.asarray(a), atol=1e-5, rtol=0)
