"""Parity of the port's fused lm-head + cross-entropy with the JAX package,
on the CPU.

The same numpy inputs go to ``opendiloco_tpu.ops.fused_xent`` (its Pallas
kernels in interpret mode, through the ``interpret_pallas_fused`` fixture)
and to ``opendiloco_torch.ops.fused_xent``, whose wrappers take their
plain versions on CPU tensors. D is 128, so the JAX package runs its
kernels and not its ``D % 128`` materializing branch (one case checks
that branch too).

Tolerances:
- f32: both sides compute the logits and their statistics in f32 and
  differ only in the order of the sums: loss rtol 1e-6, gradients atol
  2e-6 of their largest magnitude (as ``tests/test_attention.py`` holds
  the JAX kernel against the materializing loss);
- bf16 inputs: the logits are exact in f32 on both sides (a bf16 x bf16
  product is exact) and the sums differ in order, so the loss keeps rtol
  1e-5; dlog, dh and dw are rounded to bf16, and an f32 value that sits
  at a rounding boundary may round one bf16 ulp apart, so each gradient
  element holds to 2**-7 of itself (one bf16 ulp at worst) plus 1e-5 of
  the gradient's largest magnitude: where an element nearly cancels, a
  dlog entry that rounded one ulp apart moves it by up to 3.4e-6 of that
  (measured). A zeroed or sign-flipped gradient fails by orders of
  magnitude (checked below);
- the 3-step trainer trajectory: loss and grad norm rtol 1e-5; params
  atol 1e-5. Adam moves each element by about lr whatever the size of its
  gradient, except where the gradient nearly cancels over the tokens and
  comes near Adam's eps (1e-8): there the f32 rounding of the two sum
  orders is a visible share of the step (seen: single elements off by
  1.5e-6 and 4.9e-6). 1e-5 is 1% of one update at lr 1e-3.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opendiloco_tpu.models.llama import LlamaConfig as JLlamaConfig
from opendiloco_tpu.ops import fused_xent as jfx
from opendiloco_tpu.parallel.mesh import build_mesh
from opendiloco_tpu.trainer import InnerTrainer as JInnerTrainer
from opendiloco_tpu.trainer import TrainerConfig as JTrainerConfig
from opendiloco_torch.models import llama as tllama
from opendiloco_torch.models.convert import params_to_numpy
from opendiloco_torch.models.hf_io import load_config
from opendiloco_torch.ops import fused_xent as tfx
from opendiloco_torch.trainer import InnerTrainer, TrainerConfig, _resolve_perf_defaults
from test_torch_train import _np_params  # pytest puts tests/ on the path

torch.set_num_threads(2)


def _inputs(n, d, v, seed, ignore_every=7):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(n, d)).astype(np.float32)
    w = (rng.normal(size=(d, v)) * 0.02).astype(np.float32)
    labels = rng.integers(0, v, n).astype(np.int32)
    if ignore_every:
        labels[::ignore_every] = -100
    return h, w, labels


def _jax_loss_and_grads(h, w, labels, dtype):
    jh, jw = jnp.asarray(h).astype(dtype), jnp.asarray(w).astype(dtype)
    jl = jnp.asarray(labels)
    loss = jfx.fused_linear_cross_entropy(jh, jw, jl)
    dh, dw = jax.grad(jfx.fused_linear_cross_entropy, argnums=(0, 1))(jh, jw, jl)
    return float(loss), np.asarray(dh.astype(jnp.float32)), np.asarray(dw.astype(jnp.float32))


def _torch_loss_and_grads(h, w, labels, dtype):
    th = torch.from_numpy(h).to(dtype).requires_grad_(True)
    tw = torch.from_numpy(w).to(dtype).requires_grad_(True)
    loss = tfx.fused_linear_cross_entropy(th, tw, torch.from_numpy(labels).long())
    dh, dw = torch.autograd.grad(loss, (th, tw))
    assert dh.dtype == dtype and dw.dtype == dtype  # dw comes back in w's dtype
    return float(loss.detach()), dh.float().numpy(), dw.float().numpy()


def _assert_grads_close(got, ref, rel, rtol=0.0):
    """Each element within ``rtol`` of itself plus ``rel`` of the
    gradient's largest magnitude."""
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, atol=rel * float(np.abs(b).max()), rtol=rtol)


BF16_GRAD_TOL = dict(rel=1e-5, rtol=2.0**-7)


@pytest.mark.parametrize("v", [512, 1000])
@pytest.mark.parametrize("n", [1024, 240])
def test_loss_and_grads_match_jax_f32(interpret_pallas_fused, n, v):
    h, w, labels = _inputs(n, 128, v, seed=n + v)
    n0 = dict(tfx.LAUNCHES)
    jl, jdh, jdw = _jax_loss_and_grads(h, w, labels, jnp.float32)
    tl, tdh, tdw = _torch_loss_and_grads(h, w, labels, torch.float32)
    np.testing.assert_allclose(tl, jl, rtol=1e-6)
    _assert_grads_close((tdh, tdw), (jdh, jdw), 2e-6)
    assert tfx.LAUNCHES == n0  # CPU tensors take the plain versions, which launch nothing


@pytest.mark.parametrize("n,v", [(1024, 512), (240, 1000)])
def test_loss_and_grads_match_jax_bf16(interpret_pallas_fused, n, v):
    h, w, labels = _inputs(n, 128, v, seed=3 * n + v)
    jl, jdh, jdw = _jax_loss_and_grads(h, w, labels, jnp.bfloat16)
    tl, tdh, tdw = _torch_loss_and_grads(h, w, labels, torch.bfloat16)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    _assert_grads_close((tdh, tdw), (jdh, jdw), **BF16_GRAD_TOL)


@pytest.mark.parametrize("wrong", ["zero dh", "flip dh", "zero dw", "flip dw", "dw softmax part zeroed"])
def test_bf16_grad_tolerance_rejects_wrong_gradients(wrong):
    """The bf16 rule is tight enough to see a wrong gradient: each of
    these fails it against the right one (the port's own bf16 grads)."""
    h, w, labels = _inputs(1024, 128, 512, seed=3 * 1024 + 512)
    _, dh, dw = _torch_loss_and_grads(h, w, labels, torch.bfloat16)
    bad = {"zero dh": (0 * dh, dw), "flip dh": (-dh, dw), "zero dw": (dh, 0 * dw), "flip dw": (dh, -dw)}
    if wrong == "dw softmax part zeroed":  # keep only the columns that are some row's target
        targets = np.zeros(dw.shape[1], bool)
        targets[labels[labels != -100]] = True
        bad[wrong] = (dh, dw * targets)
        assert not targets.all()
    _assert_grads_close((dh, dw), (dh, dw), **BF16_GRAD_TOL)
    with pytest.raises(AssertionError):
        _assert_grads_close(bad[wrong], (dh, dw), **BF16_GRAD_TOL)


def test_materializing_branch_below_128_matches_jax():
    # D 64: both packages take the materializing branch on the CPU
    h, w, labels = _inputs(200, 64, 256, seed=5)
    jl, jdh, jdw = _jax_loss_and_grads(h, w, labels, jnp.float32)
    tl, tdh, tdw = _torch_loss_and_grads(h, w, labels, torch.float32)
    np.testing.assert_allclose(tl, jl, rtol=1e-6)
    _assert_grads_close((tdh, tdw), (jdh, jdw), 2e-6)


def test_all_labels_ignored_give_zero_loss_and_grads(interpret_pallas_fused):
    h, w, labels = _inputs(256, 128, 512, seed=6, ignore_every=0)
    labels[:] = -100
    tl, tdh, tdw = _torch_loss_and_grads(h, w, labels, torch.float32)
    jl, jdh, jdw = _jax_loss_and_grads(h, w, labels, jnp.float32)
    assert tl == jl == 0.0
    assert not tdh.any() and not tdw.any()
    assert not jdh.any() and not jdw.any()


def test_backward_chunks_sum_in_order(monkeypatch):
    """The backward walks the rows in chunks: dh lands in each chunk's rows
    and dw sums the chunks. Chunks of 100 rows over 250 (a ragged last
    chunk) give what one chunk gives, up to the order of f32 sums."""
    h, w, labels = _inputs(250, 128, 512, seed=7)
    one = _torch_loss_and_grads(h, w, labels, torch.float32)
    monkeypatch.setattr(tfx, "CHUNK_ROWS", 100)
    chunked = _torch_loss_and_grads(h, w, labels, torch.float32)
    assert chunked[0] == one[0]
    _assert_grads_close(chunked[1:], one[1:], 1e-6)


def test_plain_pieces_repeat_the_kernels_roundings():
    """dlog is rounded to h's dtype before both products, dh is written in
    h's dtype and dw is f32: the plain versions hold the kernels' contract
    on CPU tensors."""
    h, w, labels = _inputs(64, 128, 256, seed=8)
    th, tw = torch.from_numpy(h).bfloat16(), torch.from_numpy(w).bfloat16()
    tl = torch.from_numpy(labels).long()
    nll, lse = tfx.fused_xent_fwd(th, tw, tl)
    assert nll.dtype == lse.dtype == torch.float32 and not bool(nll[tl == -100].any())
    g = torch.full((64,), 1 / 64) * (tl != -100)
    dlog = tfx.fused_xent_dlog(th, tw, tl, lse, g)
    assert dlog.dtype == torch.bfloat16 and dlog.shape == (64, 256)
    dh = tfx.fused_xent_dh(dlog, tw)
    dw = tfx.fused_xent_dw(th, dlog)
    assert dh.dtype == torch.bfloat16 and dw.dtype == torch.float32
    torch.testing.assert_close(dw, th.float().T @ dlog.float())
    acc = dw.clone()
    assert tfx.fused_xent_dw(th, dlog, acc) is acc
    torch.testing.assert_close(acc, 2 * dw)


def test_sharded_entry_takes_one_device_and_refuses_a_mesh():
    h, w, labels = _inputs(32, 128, 64, seed=9)
    th, tw, tl = torch.from_numpy(h), torch.from_numpy(w), torch.from_numpy(labels).long()
    ref = tfx.fused_linear_cross_entropy(th, tw, tl)

    class Mesh:
        size = 1

    assert torch.equal(tfx.fused_linear_cross_entropy_sharded(th, tw, tl, mesh=None), ref)
    assert torch.equal(tfx.fused_linear_cross_entropy_sharded(th, tw, tl, mesh=Mesh()), ref)
    Mesh.size = 4
    with pytest.raises(NotImplementedError, match="ROADMAP.md A10"):
        tfx.fused_linear_cross_entropy_sharded(th, tw, tl, mesh=Mesh(), batch_axes=("dp",))


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

_TRAINER_CFG = dict(vocab_size=256, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
                    num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128)


def test_inner_trainer_fused_loss_matches_jax(interpret_pallas_fused):
    """3 steps of InnerTrainer(fused_loss=True) on both sides (the config of
    tests/test_attention.py test_fused_loss_matches_standard), fp32: loss,
    grad norm and the params after the last step, then eval_loss, which
    goes through the fused loss too."""
    jcfg = JLlamaConfig(**_TRAINER_CFG)
    tcfg = tllama.LlamaConfig(**_TRAINER_CFG)
    tc_kw = dict(lr=1e-3, warmup_steps=2, total_steps=50, precision="fp32", remat=False, fused_loss=True)
    params = _np_params(tcfg, 0)
    rng = np.random.default_rng(0)
    jt = JInnerTrainer(jcfg, JTrainerConfig(**tc_kw), build_mesh("NO_SHARD", devices=[jax.devices()[0]]))
    tt = InnerTrainer(tcfg, TrainerConfig(**tc_kw), device="cpu")
    assert jt.tc.fused_loss and tt.tc.fused_loss
    jstate, tstate = jt.init_state(jax.random.key(1), params), tt.init_state(params=params)
    ids = ((rng.integers(0, 256, (8, 1)) + np.arange(65)) % 256).astype(np.int32)
    labels = ids.copy()
    labels[1, :9] = -100
    for _ in range(3):
        jstate, jm = jt.train_step(jstate, jt.shard_batch(ids, labels, accum=1))
        tstate, tm = tt.train_step(tstate, tt.shard_batch(ids, labels, accum=1))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
    tparams = params_to_numpy(tstate["params"])
    for a, b in zip(jax.tree.leaves(jax.device_get(jstate["params"])), tllama.flatten_params(tparams)):
        np.testing.assert_allclose(b, np.asarray(a), atol=1e-5, rtol=0)
    assert tt.eval_loss(tstate["params"], ids, labels) == pytest.approx(
        jt.eval_loss(jstate["params"], ids, labels), rel=1e-5)


@pytest.mark.parametrize(
    "model,device,fused",
    [("1b", "cuda", True), ("150m", "cuda", False), ("1b", "cpu", False), ("150m", "cpu", False)],
)
def test_fused_loss_default_follows_the_layer_loop(model, device, fused):
    # a device object only: no card is needed to resolve the defaults
    tc = _resolve_perf_defaults(TrainerConfig(), load_config(model), torch.device(device))
    assert tc.fused_loss is fused
    assert tc.scan_unroll == (12 if (model, device) == ("150m", "cuda") else 1)


@pytest.mark.parametrize("explicit", [True, False])
def test_explicit_fused_loss_passes_through(explicit):
    cfg = load_config("2m")
    for device in ("cpu", "cuda"):
        tc = _resolve_perf_defaults(TrainerConfig(fused_loss=explicit), cfg, torch.device(device))
        assert tc.fused_loss is explicit
    trainer = InnerTrainer(cfg, TrainerConfig(fused_loss=explicit, precision="fp32"), device="cpu")
    assert trainer.tc.fused_loss is explicit and dataclasses.is_dataclass(trainer.tc)
