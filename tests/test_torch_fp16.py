"""fp16 (``precision="fp16-mixed"``) through the port's kernels, against the
JAX package, on the CPU.

The same numpy inputs, drawn from a seed, go through the JAX function at
float16 (its Pallas kernels in interpret mode) and through the port's
kernel wrappers at torch.float16, which take their plain versions for CPU
tensors: the arithmetic and roundings that every ``*_f16`` CUDA kernel
repeats (tests/test_torch_cuda_kernels.py and chip_smoke.py phase 33 hold
the kernels against these plain versions on the card).

- flash attention: B1 (out, lse), the delta, B2a (dq) and B2b (dk, dv),
  causal and full, 4 query heads over 2 kv heads, in f16 and with f16
  operands and f32 gradients (``grad_dtype``, the ring's);
- the fused lm-head + cross-entropy: B3 (nll, lse) and the backward (dh in
  h's dtype, dw f32) at D 128, so the JAX package runs its kernels;
- B6 paged decode attention and B7 spec-tail attention (one pass, and the
  split kernel's split-and-merge arithmetic), and B8 the W4 dequant-matmul;
- one flash-chunk ring at sp 2 lives in tests/test_torch_ring_attention.py
  (its f16 case);
- ``InnerTrainer(precision="fp16-mixed", attn_impl="pallas",
  fused_loss=True)`` on both sides: loss, grad norm, ``found_inf`` and
  ``loss_scale`` at every step, clean steps and overflow steps.

Tolerance, element by element: |port - JAX| <= 2**-10 |JAX| (one fp16 ulp
of the value: the f32 sums re-associate between the two frameworks before
the one rounding into f16) plus 2**-12 of the tensor's largest magnitude.
The floor is there because the roundings inside each kernel happen at f16
on both sides but against other reference points: the JAX kernels round
p = exp(s - m) against the running maximum of their key block, the plain
versions against the row's, and a p (or ds, or dlog) that lands one ulp
apart moves a sum over many of them by a fraction of an ulp of its largest
term (measured: at most 1.03e-4 of the largest output, flash forward, full
attention). The trainer holds loss and grad norm at rtol 1e-3 and the
scaler's decisions exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opendiloco_tpu.diloco.compression import pack_blockwise4_stacked as jax_pack
from opendiloco_tpu.models.llama import LlamaConfig as JLlamaConfig
from opendiloco_tpu.ops import decode_kernels as jdk
from opendiloco_tpu.ops import flash_attention as jfa
from opendiloco_tpu.ops import fused_xent as jfx
from opendiloco_tpu.parallel.mesh import build_mesh
from opendiloco_tpu.trainer import InnerTrainer as JInnerTrainer
from opendiloco_tpu.trainer import TrainerConfig as JTrainerConfig
from opendiloco_torch import quant
from opendiloco_torch.models import llama as tllama
from opendiloco_torch.ops import decode_kernels as tdk
from opendiloco_torch.ops import flash_attention as tfa
from opendiloco_torch.ops import fused_xent as tfx
from opendiloco_torch.trainer import InnerTrainer, TrainerConfig
from test_torch_train import _np_params, _ramp_batch  # pytest puts tests/ on the path

torch.set_num_threads(2)

REL, FLOOR = 2.0**-10, 2.0**-12


@pytest.fixture
def interpret_pallas(monkeypatch):
    """The JAX package's flash-attention and fused-xent kernels in
    interpreter mode (its decode kernels take ``interpret=True``)."""
    import jax.experimental.pallas as pl

    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(jfa.pl, "pallas_call", patched)
    monkeypatch.setattr(jfx.pl, "pallas_call", patched)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close16(got, ref, what: str) -> None:
    got, ref = _f32(got).astype(np.float64), _f32(ref).astype(np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    assert np.isfinite(ref).all(), what
    limit = REL * np.abs(ref) + FLOOR * float(np.abs(ref).max())
    err = np.abs(got - ref)
    worst = float((err / limit).max())
    assert (err <= limit).all(), f"{what}: worst element at {worst:.3f} of its limit"


def test_tolerance_tells_f16_from_bf16():
    """The rule is tight enough to see the type of the roundings: the same
    forward with its operands and p rounded to bf16 (what an f16 tensor
    would give on a bf16 instance) sits outside it against the f16 one."""
    q, k, v, _ = _flash_inputs(0, t=128)
    tq, tk, tv = (torch.from_numpy(a).half() for a in (q, k, v))
    out, _ = tfa.flash_attention_fwd(tq, tk, tv, True)
    wrong, _ = tfa.flash_attention_fwd(tq.bfloat16(), tk.bfloat16(), tv.bfloat16(), True)
    _close16(out.float(), out, "self")
    with pytest.raises(AssertionError):
        _close16(wrong, out, "bf16")


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

B, T, H, HKV, D = 2, 256, 4, 2, 64


def _flash_inputs(seed: int, t: int = T):
    rng = np.random.default_rng(seed)
    shapes = [(B, t, H, D), (B, t, HKV, D), (B, t, HKV, D), (B, t, H, D)]
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _bhtd(a):
    """[B, T, H, D] numpy -> the JAX kernels' [B, H, T, D] in f16."""
    return jnp.asarray(a, jnp.float16).transpose(0, 2, 1, 3)


def _btd(x):
    """The JAX kernels' [B, H, T, D] -> the port's [B, T, H, D]."""
    return jnp.asarray(x).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("grad_f32", [False, True], ids=["f16-grads", "f32-grads"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_kernels_match_jax_at_f16(interpret_pallas, causal, grad_f32):
    """B1's out (f16) and lse, the delta, B2a's dq and B2b's dk and dv, in
    f16 or (``grad_dtype`` f32, the ring's) f32, from the JAX kernels' own
    lse and delta."""
    q, k, v, do = _flash_inputs(1 if causal else 2)
    jq, jk, jv, jdo = (_bhtd(a) for a in (q, k, v, do))
    out, lse = jfa._fwd(jq, jk, jv, block_q=128, block_k=128, causal=causal)
    tq, tk, tv, tdo = (torch.from_numpy(a).half() for a in (q, k, v, do))
    tout, tlse = tfa.flash_attention_fwd(tq, tk, tv, causal)
    assert tout.dtype == torch.float16 and tlse.dtype == torch.float32
    _close16(tout, _btd(out), "out")
    _close16(tlse, np.asarray(lse)[:, :, 0], "lse")

    delta = jfa._delta(jdo, out)
    jout = torch.from_numpy(np.array(_btd(out)))
    tdelta = tfa.attention_delta(tdo, jout)
    _close16(tdelta, np.asarray(delta)[:, :, 0], "delta")
    grad_dtype = jnp.float32 if grad_f32 else None
    dq, dk, dv = jfa._bwd_impl(jq, jk, jv, jdo, lse, delta, block_q=128, block_k=128, causal=causal,
                               grad_dtype=grad_dtype)
    tl = torch.from_numpy(np.array(lse[:, :, 0]))
    tgd = torch.float32 if grad_f32 else None
    tdq = tfa.flash_attention_dq(tq, tk, tv, tdo, tl, tdelta, causal, grad_dtype=tgd)
    tdk, tdv = tfa.flash_attention_dkv(tq, tk, tv, tdo, tl, tdelta, causal, grad_dtype=tgd)
    want = torch.float32 if grad_f32 else torch.float16
    for name, got, ref in (("dq", tdq, dq), ("dk", tdk, dk), ("dv", tdv, dv)):
        assert got.dtype == want, name
        _close16(got, _btd(ref), name)


def test_flash_autograd_matches_jax_vjp_at_f16(interpret_pallas):
    """The port's FlashAttention (forward, then B2a/B2b through autograd)
    against jax.vjp of the JAX flash_attention, f16 in and out."""
    q, k, v, do = _flash_inputs(3)
    out, vjp = jax.vjp(lambda a, b, c: jfa.flash_attention(a, b, c, causal=True),
                       *(jnp.asarray(a, jnp.float16) for a in (q, k, v)))
    grads = vjp(jnp.asarray(do, jnp.float16))
    leaves = [torch.from_numpy(a).half().requires_grad_(True) for a in (q, k, v)]
    tout = tfa.flash_attention(*leaves, causal=True)
    tout.backward(torch.from_numpy(do).half())
    _close16(tout, out, "out")
    for name, leaf, ref in zip(("dq", "dk", "dv"), leaves, grads):
        assert leaf.grad.dtype == torch.float16
        _close16(leaf.grad, ref, name)


# ---------------------------------------------------------------------------
# the fused lm-head + cross-entropy
# ---------------------------------------------------------------------------


def _xent_inputs(n, d, v, seed):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(n, d)).astype(np.float32)
    w = (rng.normal(size=(d, v)) * 0.02).astype(np.float32)
    labels = rng.integers(0, v, n).astype(np.int32)
    labels[::7] = -100
    return h, w, labels


@pytest.mark.parametrize("n,v", [(256, 512), (128, 1000)])
def test_fused_xent_fwd_and_backward_match_jax_at_f16(interpret_pallas, n, v):
    """B3's nll and lse, then the backward's dh (f16) and dw (f32) from the
    JAX forward's lse and an upstream gradient of 1/n on the kept labels;
    then the mean loss and its gradients through autograd (dw rounded to
    w's dtype, f16, as the JAX vjp rounds it)."""
    h, w, labels = _xent_inputs(n, 128, v, seed=n + v)
    jh, jw, jl = jnp.asarray(h, jnp.float16), jnp.asarray(w, jnp.float16), jnp.asarray(labels)
    vp = -(-v // 256) * 256
    jw_pad = jnp.pad(jw, ((0, 0), (0, vp - v)))
    nll, lse = jfx._fwd(jh, jw_pad, jl, 128, 256, v)
    th, tw, tl = torch.from_numpy(h).half(), torch.from_numpy(w).half(), torch.from_numpy(labels).long()
    tnll, tlse = tfx.fused_xent_fwd(th, tw, tl)
    _close16(tnll, nll, "nll")
    _close16(tlse, lse, "lse")

    g = ((labels != -100) / n).astype(np.float32)
    jdh, jdw = jfx._bwd_impl(jh, jw_pad, jl, lse, jnp.asarray(g), 128, 256, v)
    tdh, tdw = tfx.fused_xent_bwd(th, tw, tl, torch.from_numpy(np.array(lse)), torch.from_numpy(g))
    assert tdh.dtype == torch.float16 and tdw.dtype == torch.float32
    _close16(tdh, jdh, "dh")
    _close16(tdw, np.asarray(jdw)[:, :v], "dw")

    loss = jfx.fused_linear_cross_entropy(jh, jw, jl)
    gh, gw = jax.grad(jfx.fused_linear_cross_entropy, argnums=(0, 1))(jh, jw, jl)
    th.requires_grad_(True)
    tw.requires_grad_(True)
    tloss = tfx.fused_linear_cross_entropy(th, tw, tl)
    th_grad, tw_grad = torch.autograd.grad(tloss, (th, tw))
    assert th_grad.dtype == tw_grad.dtype == torch.float16
    np.testing.assert_allclose(float(tloss.detach()), float(loss), rtol=REL)
    _close16(th_grad, gh, "loss dh")
    _close16(tw_grad, gw, "loss dw")


# ---------------------------------------------------------------------------
# serving kernels: B6, B7, B8
# ---------------------------------------------------------------------------


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("rep", [1, 4])
def test_paged_decode_attention_matches_jax_at_f16(rep):
    """B6: the one-pass plain version and the split kernel's arithmetic (3
    splits) against the JAX kernel, over an empty slot, a mid-block one, a
    full ring and a wrapped one."""
    Kh, S, Tr, Dh = 2, 4, 32, 16
    rng = np.random.default_rng(rep)
    q = rng.standard_normal((S, Kh * rep, Dh)).astype(np.float16)
    k, v = (rng.standard_normal((S, Tr, Kh, Dh)).astype(np.float16) for _ in range(2))
    lens = np.asarray([0, 5, Tr, 2 * Tr + 3], np.int32)
    ref = jdk.paged_decode_attention(*map(jnp.asarray, (q, k, v, lens)), block_t=8, interpret=True)
    assert ref.dtype == jnp.float16
    before = tdk.LAUNCHES.snapshot()
    out = tdk.paged_decode_attention(_t(q), _t(k), _t(v), _t(lens))
    split = tdk.paged_decode_attention_split_plain(_t(q), _t(k), _t(v), _t(lens), splits=3)
    assert tdk.LAUNCHES.snapshot() == before  # CPU tensors launch nothing
    assert out.dtype == split.dtype == torch.float16
    _close16(out, ref, "B6")
    _close16(split, ref, "B6 split")


@pytest.mark.parametrize("shape", [("verify", 4, 5, 5, 0, [0, 5, 30, 70]), ("draft", 2, 1, 4, 2, [9, 31])],
                         ids=lambda s: s[0])
def test_spec_tail_attention_matches_jax_at_f16(shape):
    """B7: the one-pass plain version and the split kernel's arithmetic (1
    and 3 splits) against the JAX kernel, with lens that leave a split empty
    and that evict."""
    _, S, Kq, Kt, q_start, lens = shape
    Tr, Hh, Kh, Dh = 32, 8, 2, 16
    rng = np.random.default_rng(Kq + Kt)
    q = rng.standard_normal((S, Kq, Hh, Dh)).astype(np.float16)
    ck, cv = (rng.standard_normal((S, Tr, Kh, Dh)).astype(np.float16) for _ in range(2))
    tk, tv = (rng.standard_normal((S, Kt, Kh, Dh)).astype(np.float16) for _ in range(2))
    lens = np.asarray(lens, np.int32)
    args = (q, ck, cv, tk, tv, lens)
    ref = jdk.spec_tail_attention_fused(*map(jnp.asarray, args), q_start=q_start, block_t=8, interpret=True)
    assert ref.dtype == jnp.float16
    targs = [_t(a) for a in args]
    _close16(tdk.spec_tail_attention_fused(*targs, q_start=q_start), ref, "B7")
    for splits in (1, 3):
        got = tdk.spec_tail_attention_split_plain(*targs, q_start=q_start, splits=splits)
        assert got.dtype == torch.float16
        _close16(got, ref, f"B7 {splits} splits")


@pytest.mark.parametrize("shape", [(64, 64), (128, 192), (64, 66)])
def test_w4_matmul_matches_jax_at_f16(shape):
    """B8: x @ dequant(W) with the weight rounded once to f16, f32 sums,
    the output in f16, against the JAX kernel at float16."""
    K, N = shape
    rng = np.random.default_rng(K + N)
    w = rng.standard_normal((1, K, N)).astype(np.float32)
    jq, js = jax_pack(w)
    tq, ts = quant.pack_blockwise4_stacked(_t(w))
    x = rng.standard_normal((8, K)).astype(np.float32)
    ref = jdk.w4_matmul(jnp.asarray(x, jnp.float16), jnp.asarray(jq[0]), jnp.asarray(js[0]), (K, N), jnp.float16,
                        interpret=True)
    assert ref.dtype == jnp.float16
    out = tdk.w4_matmul(_t(x).half(), tq[0], ts[0], (K, N), torch.float16)
    assert out.dtype == torch.float16
    _close16(out, ref, "B8")


def test_w4_route_and_flash_route_take_f16_where_they_take_bf16():
    """Every route rule takes f16 wherever it takes bf16 (so an f16 tensor
    on the card reaches the same design's f16 instance)."""
    for D in (8, 32, 40, 64, 128):
        assert tfa._on_sm90(torch.float16, D) == tfa._on_sm90(torch.bfloat16, D)
        assert tfa._fwd_route(torch.float16, D) == tfa._fwd_route(torch.bfloat16, D)
        assert tfa._bwd_route(torch.float16, D) == tfa._bwd_route(torch.bfloat16, D)
    assert tfx._route(torch.float16) == tfx._route(torch.bfloat16) == tfx.SM90_SOURCE
    for K, N in ((2048, 2048), (2048, 256), (64, 96), (12, 64)):
        assert tdk.w4_route(torch.float16, K, N) == tdk.w4_route(torch.bfloat16, K, N)
    from opendiloco_torch.ops.launch import SUFFIX

    assert SUFFIX[torch.float16] == "f16"


def test_every_bf16_symbol_has_an_f16_twin():
    """Each ``*_bf16`` C entry of the CUDA sources has an ``*_f16`` entry
    of the same parameters (the wrappers look both up by ``SUFFIX``)."""
    import os
    import re

    csrc = os.path.join(os.path.dirname(tfa.__file__), "..", "csrc")
    entry = re.compile(r"^int (\w+)_(bf16|f16)\(([^)]*)\)", re.M)
    found = 0
    for name in sorted(os.listdir(csrc)):
        if not name.endswith(".cu"):
            continue
        with open(os.path.join(csrc, name)) as f:
            src = f.read()
        sigs = {(m[1], m[2]): " ".join(m[3].split()) for m in entry.finditer(src)}
        for (stem, kind), params in sigs.items():
            if kind == "bf16":
                found += 1
                assert sigs.get((stem, "f16")) == params, f"{name}: {stem}_f16 missing or unlike {stem}_bf16"
    assert found >= 20


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------


def _widths(hidden: int) -> dict:
    return dict(vocab_size=256, hidden_size=hidden, intermediate_size=2 * hidden, num_hidden_layers=2,
                num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128)


@pytest.mark.parametrize(
    "hidden,scale,steps",
    [
        # tiny_cfg's widths: three clean steps at 2**10
        (64, 2.0**10, 3),
        # at 2**21 steps 1 and 2 are clean, step 3 overflows (skipped, the
        # scale halves) and step 4 is clean again at 2**20
        (64, 2.0**21, 4),
        # D 128: the JAX package runs its fused-xent kernels, not its
        # materializing branch; steps 3 and 4 overflow
        (128, 2.0**21, 4),
    ],
    ids=["tiny-2^10", "tiny-2^21", "d128-2^21"],
)
def test_fp16_trainer_with_kernels_matches_jax(interpret_pallas, tiny_cfg, hidden, scale, steps):
    """InnerTrainer(precision="fp16-mixed", attn_impl="pallas",
    fused_loss=True) on both sides from the same params and batches: loss
    and grad norm at rtol 1e-3 on clean steps, found_inf and loss_scale
    equal at every step; an overflow step leaves params and moments as
    they were."""
    widths = _widths(hidden)
    if hidden == 64:
        assert widths == {k: getattr(tiny_cfg, k) for k in widths}
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=20, precision="fp16-mixed", remat=True, attn_impl="pallas",
              fused_loss=True, init_loss_scale=scale, max_grad_norm=1.0)
    tcfg = tllama.LlamaConfig(**widths)
    params = _np_params(tcfg, 8)
    jt = JInnerTrainer(JLlamaConfig(**widths), JTrainerConfig(**kw), build_mesh("NO_SHARD", devices=[jax.devices()[0]]))
    tt = InnerTrainer(tcfg, TrainerConfig(**kw), device="cpu")
    assert jt.tc.fused_loss and tt.tc.fused_loss and tt.tc.attn_impl == "pallas"
    jstate, tstate = jt.init_state(jax.random.key(0), params), tt.init_state(params=params)
    rng = np.random.default_rng(9)
    seen = set()
    for step in range(steps):
        ids, labels = _ramp_batch(rng, tcfg.vocab_size, 4, 128)
        before = [p.detach().clone() for p in tllama.flatten_params(tstate["params"])]
        mu = [m.clone() for m in tstate["opt_state"]["mu"]]
        jstate, jm = jt.train_step(jstate, jt.shard_batch(ids, labels, accum=1))
        tstate, tm = tt.train_step(tstate, tt.shard_batch(ids, labels, accum=1))
        found = float(tm["found_inf"])
        assert found == float(jm["found_inf"]), step
        assert float(tm["loss_scale"]) == float(jm["loss_scale"]), step
        assert tstate["scaler"]["scale"] == float(jstate["scaler"]["scale"]), step
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-3)
        if found:
            assert not np.isfinite(float(tm["grad_norm"])) and not np.isfinite(float(jm["grad_norm"]))
            assert all(torch.equal(a, b) for a, b in zip(tllama.flatten_params(tstate["params"]), before))
            assert all(torch.equal(a, b) for a, b in zip(tstate["opt_state"]["mu"], mu))
        else:
            np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-3)
        seen.add(found)
    assert seen == ({0.0} if scale == 2.0**10 else {0.0, 1.0})
