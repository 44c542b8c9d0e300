"""The port's hand-written CUDA kernels against their plain PyTorch versions.

Every test here needs a CUDA card and skips where there is none (the
``cuda`` fixture decides, never the import). The file imports no JAX, so
on a machine with a card and no JAX it runs without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

Tolerances: f32 results differ from the plain versions only by the order
of f32 sums (atol 1e-5 for attention outputs of magnitude <= 1, 1e-5
relative to the largest output for K-long W4 products); bf16 attention
rounds p to bf16 at each tile's running max where the plain version rounds
at the global max, and both round the output to bf16, so 2**-6 of each
slot's largest output (two to four bf16 ulps there; per slot, because a
long ring averages its rows to small outputs while a one-row slot returns
v itself).
"""
import pytest
import torch

from opendiloco_torch import quant
from opendiloco_torch.ops import decode_kernels as tdk

torch.set_num_threads(2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _attn_inputs(dev, S, T, Kh, rep, D, dtype, lens):
    g = torch.Generator(device=dev).manual_seed(S * T + D)
    q = torch.randn(S, Kh * rep, D, generator=g, device=dev).to(dtype)
    k = torch.randn(S, T, Kh, D, generator=g, device=dev).to(dtype)
    v = torch.randn(S, T, Kh, D, generator=g, device=dev).to(dtype)
    return q, k, v, torch.tensor(lens, dtype=torch.int32, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "geom",
    [
        (4, 64, 2, 4, 64, [0, 31, 40, 200]),  # empty, mid-tile, wrapped
        (3, 40, 1, 1, 8, [39, 1, 17]),  # D 8, rep 1, a ragged last tile
        (2, 96, 2, 3, 256, [95, 5]),  # D 256, odd rep
        (2, 300, 1, 12, 256, [299, 150]),  # rep 12: two query groups; opt-in shared memory
        (8, 1024, 4, 8, 64, [0, 1, 255, 256, 700, 1023, 1500, 511]),  # config_1b decode
    ],
)
def test_paged_decode_attention_matches_plain(cuda, dtype, geom):
    S, T, Kh, rep, D, lens = geom
    q, k, v, ln = _attn_inputs(cuda, S, T, Kh, rep, D, dtype, lens)
    n0 = tdk.LAUNCHES["paged_decode_attention"]
    out = tdk.paged_decode_attention(q, k, v, ln)
    torch.cuda.synchronize()
    assert tdk.LAUNCHES["paged_decode_attention"] == n0 + 1
    assert out.dtype == dtype and out.shape == q.shape
    ref = tdk.paged_decode_attention_plain(q, k, v, ln).float()
    err = (out.float() - ref).abs().amax(dim=(1, 2))
    if dtype == torch.float32:
        tol = torch.full_like(err, 1e-5)
    else:
        tol = 2.0**-6 * ref.abs().amax(dim=(1, 2))
    assert bool((err <= tol).all()), f"per-slot error {err.tolist()} over tolerance {tol.tolist()}"


@pytest.mark.cuda
def test_paged_decode_attention_reads_no_dead_rows(cuda):
    # rows past the live length hold NaN: a kernel that read them would
    # return NaN, since 0 * NaN is NaN
    S, T, Kh, rep, D = 2, 128, 2, 2, 64
    q, k, v, ln = _attn_inputs(cuda, S, T, Kh, rep, D, torch.float32, [10, 70])
    k[0, 11:] = float("nan")
    v[0, 11:] = float("nan")
    k[1, 71:] = float("nan")
    v[1, 71:] = float("nan")
    out = tdk.paged_decode_attention(q, k, v, ln)
    assert torch.isfinite(out).all()
    ref = tdk.paged_decode_attention_plain(
        q, torch.nan_to_num(k), torch.nan_to_num(v), ln
    )
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "bad",
    [
        dict(D=12),  # not a multiple of 8
        dict(D=264),  # above 256
        dict(H=6),  # 6 query heads over 4 kv heads
        dict(dtype=torch.float16),
    ],
)
def test_paged_decode_attention_rejects(cuda, bad):
    D, H, dtype = bad.get("D", 64), bad.get("H", 8), bad.get("dtype", torch.float32)
    q = torch.zeros(2, H, D, device=cuda, dtype=dtype)
    k = torch.zeros(2, 16, 4, D, device=cuda, dtype=dtype)
    lens = torch.zeros(2, dtype=torch.int32, device=cuda)
    n0 = tdk.LAUNCHES["paged_decode_attention"]
    with pytest.raises(ValueError):
        tdk.paged_decode_attention(q, k, k, lens)
    assert tdk.LAUNCHES["paged_decode_attention"] == n0


@pytest.mark.cuda
def test_wrappers_reject_mixed_devices(cuda):
    q = torch.zeros(2, 8, 64, device=cuda)
    k = torch.zeros(2, 16, 4, 64)
    with pytest.raises(ValueError):
        tdk.paged_decode_attention(q, k, k, torch.zeros(2, dtype=torch.int32))


def _packed(dev, K, N, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, s = quant.pack_blockwise4_stacked(torch.randn(1, K, N, generator=g, device=dev))
    return q[0], s[0], g


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(256, 320), (2048, 256), (64, 66), (5632, 2048)])
@pytest.mark.parametrize("M", [1, 8, 37])
def test_w4_matmul_f32_matches_plain(cuda, shape, M):
    K, N = shape
    q, s, g = _packed(cuda, K, N)
    x = torch.randn(M, K, generator=g, device=cuda)
    n0 = tdk.LAUNCHES["w4_matmul"]
    out = tdk.w4_matmul(x, q, s, shape, torch.float32)
    torch.cuda.synchronize()
    assert tdk.LAUNCHES["w4_matmul"] == n0 + 1
    ref = tdk.w4_matmul_plain(x, q, s, shape, torch.float32)
    scale = float(ref.abs().max())
    torch.testing.assert_close(out / scale, ref / scale, atol=1e-5, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(256, 320), (64, 66), (2048, 256)])
def test_w4_identity_probe_is_bitwise_dequant(cuda, shape):
    K, N = shape
    q, s, _ = _packed(cuda, K, N, seed=1)
    eye = tdk.w4_matmul(torch.eye(K, device=cuda), q, s, shape, torch.float32)
    assert torch.equal(eye, quant.dequant_w4(q, s, shape, torch.float32))


@pytest.mark.cuda
def test_w4_matmul_rejects_odd_columns_on_card(cuda):
    from opendiloco_torch.models.llama import PackedW4, _wmul

    q, s, g = _packed(cuda, 16, 7, seed=3)
    x = torch.randn(2, 16, generator=g, device=cuda)
    n0 = tdk.LAUNCHES["w4_matmul"]
    with pytest.raises(ValueError):
        tdk.w4_matmul(x, q, s, (16, 7), torch.float32)
    with pytest.raises(ValueError):
        _wmul(x, PackedW4(q, s, (16, 7)), torch.float32)
    assert tdk.LAUNCHES["w4_matmul"] == n0


@pytest.mark.cuda
def test_w4_matmul_bf16_matches_plain(cuda):
    K, N = 2048, 512
    q, s, g = _packed(cuda, K, N, seed=2)
    x = torch.randn(8, K, generator=g, device=cuda).to(torch.bfloat16)
    out = tdk.w4_matmul(x, q, s, (K, N), torch.bfloat16)
    ref = tdk.w4_matmul_plain(x, q, s, (K, N), torch.bfloat16)
    assert out.dtype == torch.bfloat16
    # both sum in f32 (in different orders) and round once to bf16: at
    # most one bf16 ulp apart, 2**-7 relative
    torch.testing.assert_close(out.float(), ref.float(), rtol=2**-7, atol=1e-3)


# ---------------------------------------------------------------------------
# flash attention: B1, B2a, B2b
# ---------------------------------------------------------------------------

FLASH_GEOMS = [
    # B, T, H, Hkv, D
    (2, 256, 4, 2, 64),  # the CPU parity shape
    (1, 1000, 4, 1, 64),  # odd T (ragged tail tile), rep 4
    (1, 100, 3, 3, 8),  # D 8, T shorter than a tile
    (1, 130, 2, 2, 128),  # D 128
    (1, 70, 4, 2, 40),  # D not a multiple of 16
    (2, 1024, 32, 4, 64),  # config_1b head geometry
]


def _flash_inputs(dev, B, T, H, Hkv, D, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed + T + D)
    q = torch.randn(B, T, H, D, generator=g, device=dev).to(dtype)
    k = torch.randn(B, T, Hkv, D, generator=g, device=dev).to(dtype)
    v = torch.randn(B, T, Hkv, D, generator=g, device=dev).to(dtype)
    do = torch.randn(B, T, H, D, generator=g, device=dev).to(dtype)
    return q, k, v, do


def _flash_tol(ref, dtype):
    """f32: the kernel and the plain version differ only in the order of
    f32 sums, 1e-5 of the output's largest magnitude (at least 1e-5).
    bf16: p and ds are rounded to bf16 in both, at points that differ by
    the f32 rounding of what precedes them (p at each tile's running max
    in B1), and the outputs round to bf16: 2**-6 of each head's largest
    output, two to four bf16 ulps there."""
    ref = ref.float()
    if dtype == torch.float32:
        return torch.full(ref.shape[:1] + ref.shape[2:3], 1e-5 * max(1.0, float(ref.abs().max())),
                          device=ref.device)
    return 2.0**-6 * ref.abs().amax(dim=(1, 3))


def _flash_err(out, ref):
    """Per (batch, head) max |out - ref| of [B, T, H, D] tensors."""
    return (out.float() - ref.float()).abs().amax(dim=(1, 3))


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("geom", FLASH_GEOMS, ids=lambda g: "x".join(map(str, g)))
def test_flash_attention_kernels_match_plain(cuda, geom, dtype, causal):
    from opendiloco_torch.ops import flash_attention as tfa

    B, T, H, Hkv, D = geom
    q, k, v, do = _flash_inputs(cuda, *geom, dtype)
    n0 = dict(tdk.LAUNCHES)
    out, lse = tfa.flash_attention_fwd(q, k, v, causal)
    ref_out, ref_lse = tfa.flash_attention_fwd_plain(q, k, v, causal)
    delta = tfa.attention_delta(do, ref_out)
    dq = tfa.flash_attention_dq(q, k, v, do, ref_lse, delta, causal)
    dk, dv = tfa.flash_attention_dkv(q, k, v, do, ref_lse, delta, causal)
    torch.cuda.synchronize()
    for name in ("flash_attention_fwd", "flash_attention_dq", "flash_attention_dkv"):
        assert tdk.LAUNCHES[name] == n0[name] + 1
    assert out.dtype == dtype and lse.dtype == torch.float32 and lse.shape == (B, H, T)
    assert dq.dtype == dtype and dk.shape == k.shape and dv.shape == v.shape
    # lse is f32 in both: only the order of sums differs
    assert float((lse - ref_lse).abs().max()) <= 1e-4 * max(1.0, float(ref_lse.abs().max()))
    ref_dq = tfa.flash_attention_dq_plain(q, k, v, do, ref_lse, delta, causal)
    ref_dk, ref_dv = tfa.flash_attention_dkv_plain(q, k, v, do, ref_lse, delta, causal)
    for name, got, ref in (("out", out, ref_out), ("dq", dq, ref_dq), ("dk", dk, ref_dk), ("dv", dv, ref_dv)):
        err, tol = _flash_err(got, ref), _flash_tol(ref, dtype)
        print(f"{name} {geom} {dtype} causal={causal}: max err/tol {float((err / tol).max()):.3f}")
        assert bool((err <= tol).all()), f"{name}: per-head error {err.tolist()} over {tol.tolist()}"


@pytest.mark.cuda
def test_flash_attention_kernels_repeat_bitwise(cuda):
    from opendiloco_torch.ops import flash_attention as tfa

    q, k, v, do = _flash_inputs(cuda, 2, 512, 8, 2, 64, torch.bfloat16)
    runs = []
    for _ in range(2):
        out, lse = tfa.flash_attention_fwd(q, k, v, True)
        delta = tfa.attention_delta(do, out)
        runs.append((out, lse, tfa.flash_attention_dq(q, k, v, do, lse, delta),
                     *tfa.flash_attention_dkv(q, k, v, do, lse, delta)))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_flash_attention_f32_grads_from_bf16(cuda):
    from opendiloco_torch.ops import flash_attention as tfa

    q, k, v, do = _flash_inputs(cuda, 1, 200, 4, 2, 64, torch.bfloat16)
    out, lse = tfa.flash_attention_fwd_plain(q, k, v)
    delta = tfa.attention_delta(do, out)
    dq = tfa.flash_attention_dq(q, k, v, do, lse, delta, grad_dtype=torch.float32)
    dk, dv = tfa.flash_attention_dkv(q, k, v, do, lse, delta, grad_dtype=torch.float32)
    assert dq.dtype == dk.dtype == dv.dtype == torch.float32
    ref_dq = tfa.flash_attention_dq_plain(q, k, v, do, lse, delta, grad_dtype=torch.float32)
    ref_dk, ref_dv = tfa.flash_attention_dkv_plain(q, k, v, do, lse, delta, grad_dtype=torch.float32)
    for got, ref in ((dq, ref_dq), (dk, ref_dk), (dv, ref_dv)):
        # f32 outputs: only the f32 sums (and where ds rounds) differ
        assert bool((_flash_err(got, ref) <= _flash_tol(ref, torch.bfloat16)).all())


@pytest.mark.cuda
def test_flash_attention_autograd_matches_plain_attention(cuda):
    from opendiloco_torch.ops.attention import xla_attention
    from opendiloco_torch.ops.flash_attention import flash_attention

    q, k, v, do = _flash_inputs(cuda, 2, 300, 4, 2, 32, torch.float32)
    grads = []
    for fn in (flash_attention, lambda a, b, c, causal: xla_attention(a, b, c, causal=causal)):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = fn(*leaves, causal=True)
        out.backward(do)
        grads.append([out.detach(), *(t.grad for t in leaves)])
    for got, ref in zip(*grads):
        torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "bad",
    [
        dict(D=12),  # not a multiple of 8
        dict(D=136),  # above 128
        dict(H=6),  # 6 query heads over 4 kv heads
        dict(dtype=torch.float16),  # fp16-mixed is not ported to the kernels
        dict(strided=True),  # not contiguous
    ],
)
def test_flash_attention_rejects(cuda, bad):
    from opendiloco_torch.ops import flash_attention as tfa

    D, H, dtype = bad.get("D", 64), bad.get("H", 8), bad.get("dtype", torch.float32)
    q = torch.zeros(2, 32, H, D, device=cuda, dtype=dtype)
    k = torch.zeros(2, 32, 4, D, device=cuda, dtype=dtype)
    if bad.get("strided"):
        q = torch.zeros(2, H, 32, D, device=cuda, dtype=dtype).transpose(1, 2)
    lse = torch.zeros(2, H, 32, device=cuda)
    n0 = dict(tdk.LAUNCHES)
    with pytest.raises(ValueError):
        tfa.flash_attention_fwd(q, k, k)
    with pytest.raises(ValueError):
        tfa.flash_attention_dq(q, k, k, q, lse, lse)
    with pytest.raises(ValueError):
        tfa.flash_attention_dkv(q, k, k, q, lse, lse)
    assert tdk.LAUNCHES == n0
