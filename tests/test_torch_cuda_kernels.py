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
