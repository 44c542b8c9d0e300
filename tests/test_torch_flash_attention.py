"""Parity of the port's flash attention with the JAX package, on the CPU.

The same numpy inputs go through the JAX kernels (``_fwd`` and
``_bwd_impl``, Pallas in interpret mode, as tests/test_attention.py runs
them) and through the port's ``FlashAttention`` autograd function and
kernel wrappers, which take their plain versions for CPU tensors. B 2,
T 256, 4 query heads over 2 kv heads, D 64, causal and full, f32.

Tolerance: atol 2e-5 on outputs and lse of magnitude <= ~5, and 2e-5
relative to the largest gradient: both sides compute in f32 and differ
only in the order of their sums (the TPU kernel walks 256-row blocks with
an online softmax, the plain version sums each row in one pass).

The CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_cuda_kernels.py and chip_smoke.py.

With ``OPENDILOCO_TORCH_PARITY_RECORD`` naming a folder, the forward
parity test saves its inputs and both sides' outputs there, one ``.npz`` a
run (pass or fail), so a run that misses its tolerance can be held against
a clean one to see which side moved (ROADMAP queue C, C3).
"""
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opendiloco_torch.ops import flash_attention as tfa
from opendiloco_torch.ops.attention import xla_attention as t_xla_attention

torch.set_num_threads(2)

B, T, H, HKV, D = 2, 256, 4, 2, 64
ATOL = 2e-5


@pytest.fixture
def interpret_pallas(monkeypatch):
    """Run the JAX package's Pallas kernels in interpreter mode."""
    import jax.experimental.pallas as pl

    from opendiloco_tpu.ops import flash_attention as fa

    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(fa.pl, "pallas_call", patched)
    return fa


def _inputs(seed=0, t=T):
    rng = np.random.default_rng(seed)
    shapes = [(B, t, H, D), (B, t, HKV, D), (B, t, HKV, D), (B, t, H, D)]
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _bhtd(a):
    """[B, T, H, D] numpy -> the JAX kernels' [B, H, T, D]."""
    return jnp.asarray(a).transpose(0, 2, 1, 3)


def _close(got, want, rel=False):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    tol = ATOL * (max(1.0, float(np.abs(want).max())) if rel else 1.0)
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_forward_out_and_lse_match_jax_kernel(interpret_pallas, causal):
    fa = interpret_pallas
    q, k, v, _ = _inputs()
    out, lse = fa._fwd(_bhtd(q), _bhtd(k), _bhtd(v), block_q=128, block_k=128, causal=causal)
    tout, tlse = tfa.flash_attention_fwd(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal)
    record = os.environ.get("OPENDILOCO_TORCH_PARITY_RECORD")
    if record:
        os.makedirs(record, exist_ok=True)
        name = f"fwd-{'causal' if causal else 'full'}-{os.getpid()}-{time.time_ns()}.npz"
        np.savez(os.path.join(record, name), q=q, k=k, v=v, jax_out=np.asarray(out), jax_lse=np.asarray(lse),
                 torch_out=tout.numpy(), torch_lse=tlse.numpy())
    try:
        _close(tout.numpy(), np.asarray(out).transpose(0, 2, 1, 3))
        _close(tlse.numpy(), np.asarray(lse)[:, :, 0])
    except AssertionError as miss:
        # a miss here has never repeated on demand (ROADMAP queue C, C3):
        # compute both sides again on the same inputs and say which moved
        out2, lse2 = fa._fwd(_bhtd(q), _bhtd(k), _bhtd(v), block_q=128, block_k=128, causal=causal)
        tout2, tlse2 = tfa.flash_attention_fwd(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                               causal)
        pytest.fail(_which_side_moved(
            {"out": np.asarray(out), "lse": np.asarray(lse)}, {"out": np.asarray(out2), "lse": np.asarray(lse2)},
            {"out": tout.numpy(), "lse": tlse.numpy()}, {"out": tout2.numpy(), "lse": tlse2.numpy()},
        ) + f"\nfirst comparison: {miss}")


def _which_side_moved(jax_first, jax_again, torch_first, torch_again) -> str:
    """Name the side (JAX, torch, both or neither) whose second run on the
    same inputs differs from its first, with the largest change of each."""
    def moved(first, again):
        return {k: float(np.max(np.abs(first[k].astype(np.float64) - again[k])))
                for k in first if not np.array_equal(first[k], again[k])}

    j, t = moved(jax_first, jax_again), moved(torch_first, torch_again)
    side = {(False, False): "neither", (True, False): "JAX", (False, True): "torch",
            (True, True): "both"}[(bool(j), bool(t))]
    return f"forward parity missed; on a second run {side} side moved (JAX: {j or 'no change'}, torch: " \
           f"{t or 'no change'})"


def test_which_side_moved_names_the_side():
    a, b = {"out": np.zeros(3, np.float32)}, {"out": np.array([0, 0.5, 0], np.float32)}
    assert "neither side moved" in _which_side_moved(a, a, a, a)
    assert "JAX side moved" in _which_side_moved(a, b, a, a)
    msg = _which_side_moved(a, a, a, b)
    assert "torch side moved" in msg and "'out': 0.5" in msg
    assert "both side moved" in _which_side_moved(a, b, a, b)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_backward_kernels_match_jax_bwd_impl(interpret_pallas, causal):
    """dq (B2a) and dk/dv (B2b) from the same lse and delta as the JAX
    ``_bwd_impl``, and the port's delta against ``_delta``."""
    fa = interpret_pallas
    q, k, v, do = _inputs(1)
    out, lse = fa._fwd(_bhtd(q), _bhtd(k), _bhtd(v), block_q=128, block_k=128, causal=causal)
    delta = fa._delta(_bhtd(do), out)
    dq, dk, dv = fa._bwd_impl(
        _bhtd(q), _bhtd(k), _bhtd(v), _bhtd(do), lse, delta, block_q=128, block_k=128, causal=causal
    )
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    tout = torch.from_numpy(np.ascontiguousarray(np.asarray(out).transpose(0, 2, 1, 3)))
    tdelta = tfa.attention_delta(tdo, tout)
    _close(tdelta.numpy(), np.asarray(delta)[:, :, 0], rel=True)
    tlse = torch.from_numpy(np.array(lse[:, :, 0]))
    tdq = tfa.flash_attention_dq(tq, tk, tv, tdo, tlse, tdelta, causal)
    tdk, tdv = tfa.flash_attention_dkv(tq, tk, tv, tdo, tlse, tdelta, causal)
    for got, want in ((tdq, dq), (tdk, dk), (tdv, dv)):
        _close(got.numpy(), np.asarray(want).transpose(0, 2, 1, 3), rel=True)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_autograd_function_matches_jax_flash_attention(interpret_pallas, causal):
    """The port's ``FlashAttention`` (forward, then B2a/B2b through
    autograd) against ``jax.vjp`` of the JAX ``flash_attention``."""
    fa = interpret_pallas
    q, k, v, do = _inputs(2)
    out, vjp = jax.vjp(lambda a, b, c: fa.flash_attention(a, b, c, causal=causal),
                       jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    grads = vjp(jnp.asarray(do))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    tout = tfa.flash_attention(*leaves, causal=causal)
    tout.backward(torch.from_numpy(do))
    _close(tout.detach().numpy(), out)
    for leaf, want in zip(leaves, grads):
        _close(leaf.grad.numpy(), want, rel=True)


def test_autograd_function_matches_plain_attention_autograd():
    """Against autograd through the plain ``xla_attention`` (a different
    algorithm: softmax over the full row, no lse)."""
    q, k, v, do = _inputs(3, t=96)
    grads = []
    for fn in (tfa.flash_attention, t_xla_attention):
        leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
        out = fn(*leaves, causal=True)
        out.backward(torch.from_numpy(do))
        grads.append([out.detach().numpy()] + [leaf.grad.numpy() for leaf in leaves])
    for got, want in zip(*grads):
        _close(got, want, rel=True)


def test_plain_versions_round_like_the_kernels():
    """In bf16 the plain forward rounds p to v's dtype before p.v: it
    differs from the f32 product by at most a bf16 rounding of p."""
    q, k, v, _ = (torch.from_numpy(a).to(torch.bfloat16) for a in _inputs(4, t=64))
    out, lse = tfa.flash_attention_fwd(q, k, v, True)
    ref, ref_lse = tfa.flash_attention_fwd(q.float(), k.float(), v.float(), True)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    torch.testing.assert_close(lse, ref_lse, atol=1e-5, rtol=0)
    # p and the output each round to bf16 (8 bits): 2**-6 of the largest output
    assert float((out.float() - ref).abs().max()) <= 2.0**-6 * float(ref.abs().max())


def test_cpu_tensors_never_launch_a_kernel():
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(5, t=32))
    from opendiloco_torch.ops.launch import LAUNCHES

    before = dict(LAUNCHES)
    out, lse = tfa.flash_attention_fwd(q, k, v)
    delta = tfa.attention_delta(do, out)
    tfa.flash_attention_dq(q, k, v, do, lse, delta)
    tfa.flash_attention_dkv(q, k, v, do, lse, delta)
    assert LAUNCHES == before
    for name in ("flash_attention_fwd", "flash_attention_dq", "flash_attention_dkv", "flash_attention_fwd_sm90",
                 "flash_attention_dq_sm90", "flash_attention_dkv_sm90", "flash_attention_delta"):
        assert name in LAUNCHES


def test_wrappers_reject_mixed_devices():
    q = torch.zeros(1, 8, 2, 8)
    k = torch.zeros(1, 8, 2, 8, device="meta")
    with pytest.raises(ValueError):
        tfa.flash_attention_fwd(q, k, k)


def test_launch_counter_is_exact_under_threads():
    """One counter serves every kernel; two workers in two threads launch
    concurrently, and no count may be lost."""
    import threading

    from opendiloco_torch.ops import decode_kernels as tdk
    from opendiloco_torch.ops.launch import LaunchCounter

    counter = LaunchCounter()
    names = ("flash_attention_fwd", "flash_attention_dq")

    def hammer():
        for i in range(20000):
            counter.add(names[i % 2])

    threads = [threading.Thread(target=hammer) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert counter.snapshot() == {names[0]: 40000, names[1]: 40000}
    counter.reset()
    assert counter == {names[0]: 0, names[1]: 0}
    # both kernel modules report through the one shared counter
    assert tfa.LAUNCHES is tdk.LAUNCHES
