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
v itself). f16 keeps 3 more mantissa bits than bf16 and rounds at the same
points, so each f16 limit is the bf16 one over 8 (``F16``).
"""
import pytest
import torch

from opendiloco_torch import quant
from opendiloco_torch.ops import decode_kernels as tdk

torch.set_num_threads(2)


# the bf16 limits of the tests below over 8: f16 has 10 mantissa bits to
# bf16's 7, and the kernels round at the same points in both
F16 = 2.0**-3
# attention outputs, per slot or head, as a share of its largest output
ATTN_SHARE = {torch.bfloat16: 2.0**-6, torch.float16: 2.0**-6 * F16}


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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
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
    # the split kernel up to D 128, the first design above
    name = "paged_decode_attention" if D <= tdk.SPLIT_MAX_D else "paged_decode_attention_first"
    n0 = tdk.LAUNCHES[name]
    out = tdk.paged_decode_attention(q, k, v, ln)
    torch.cuda.synchronize()
    assert tdk.LAUNCHES[name] == n0 + 1
    assert out.dtype == dtype and out.shape == q.shape
    ref = tdk.paged_decode_attention_plain(q, k, v, ln).float()
    err = (out.float() - ref).abs().amax(dim=(1, 2))
    if dtype == torch.float32:
        tol = torch.full_like(err, 1e-5)
    else:
        tol = ATTN_SHARE[dtype] * ref.abs().amax(dim=(1, 2))
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


# (S, T, Kh, rep, D, lens, splits): config_1b's decode shape at the
# wrapper's splits (8 of 128 rows) and forced to 1 and 3 (a split boundary
# inside the live ring), its split edges (live rows ending just before, on
# and past a boundary), and small odd shapes: D 8 and rep 1 in 8 splits of
# 5 rows, D 128 with an odd rep, rep 12 (a block of 16 rows, 12 real)
PAGED_SPLIT_GEOMS = [
    *((8, 1024, 4, 8, 64, [0, 1, 255, 256, 700, 1023, 1500, 511], sp) for sp in (None, 1, 3)),
    (8, 1024, 4, 8, 64, [0, 126, 127, 128, 129, 1022, 1024, 2049], None),
    (3, 40, 1, 1, 8, [39, 1, 17], 8),
    (2, 96, 2, 3, 128, [95, 5], 3),
    (2, 300, 1, 12, 40, [299, 150], 3),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("geom", PAGED_SPLIT_GEOMS, ids=lambda g: "x".join(map(str, g[:5])) + f"-s{g[6]}")
def test_paged_decode_attention_splits_match_plain_and_repeat(cuda, geom, dtype):
    """B6 on the split kernel against the one-pass and the split plain
    versions (the tolerances of test_paged_decode_attention_matches_plain),
    finite and bit for bit on a second launch; the merge runs, under its
    own name, exactly when there is more than one split."""
    S, T, Kh, rep, D, lens, splits = geom
    q, k, v, ln = _attn_inputs(cuda, S, T, Kh, rep, D, dtype, lens)
    n0 = dict(tdk.LAUNCHES)
    out = tdk.paged_decode_attention(q, k, v, ln, splits=splits)
    again = tdk.paged_decode_attention(q, k, v, ln, splits=splits)
    torch.cuda.synchronize()
    used = splits or tdk.spec_tail_splits(S, T, Kh, rep, tdk._sm_count(cuda.index or 0))
    used = tdk.spec_tail_split_chunk(T, used)[0]
    assert tdk.LAUNCHES["paged_decode_attention"] == n0["paged_decode_attention"] + 2
    merges = tdk.LAUNCHES["paged_decode_attention_merge"] - n0["paged_decode_attention_merge"]
    assert merges == (2 if used > 1 else 0)
    for name in ("paged_decode_attention_first", "spec_tail_attention", "spec_tail_attention_merge"):
        assert tdk.LAUNCHES[name] == n0[name]
    assert out.dtype == dtype and out.shape == q.shape
    assert bool(torch.isfinite(out.float()).all()) and torch.equal(out, again)
    for ref in (tdk.paged_decode_attention_plain(q, k, v, ln),
                tdk.paged_decode_attention_split_plain(q, k, v, ln, splits=used)):
        ref = ref.float()
        err = (out.float() - ref).abs().amax(dim=(1, 2))
        tol = torch.full_like(err, 1e-5) if dtype == torch.float32 else ATTN_SHARE[dtype] * ref.abs().amax(dim=(1, 2))
        assert bool((err <= tol).all()), f"per-slot error {err.tolist()} over tolerance {tol.tolist()}"
    print(f"B6 {geom[:5]} splits {used} {dtype}: max err/tol {float((err / tol).max()):.3f}")


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [3, 8])
def test_paged_decode_attention_splits_read_no_dead_rows(cuda, splits):
    # as test_paged_decode_attention_reads_no_dead_rows, with the ring cut
    # into splits: those past a slot's live rows load nothing
    S, T, Kh, rep, D = 2, 128, 2, 8, 64
    q, k, v, ln = _attn_inputs(cuda, S, T, Kh, rep, D, torch.float32, [10, 70])
    clean = (k.clone(), v.clone())
    for t in (k, v):
        t[0, 11:] = float("nan")
        t[1, 71:] = float("nan")
    out = tdk.paged_decode_attention(q, k, v, ln, splits=splits)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, tdk.paged_decode_attention_plain(q, *clean, ln), atol=1e-5, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_paged_decode_merge_matches_its_plain_version(cuda, dtype):
    """B6's merge against B7's plain merge on B6's own partials at the
    config_1b decode shape: the same f32 sums in the same order (f32 1e-6,
    bf16 2**-8 and f16 2**-11 of the largest output)."""
    S, T, Kh, rep, D = 8, 1024, 4, 8, 64
    q, k, v, ln = _attn_inputs(cuda, S, T, Kh, rep, D, dtype, [0, 5, 127, 128, 700, 1023, 1024, 2049])
    ml, acc = tdk._paged_decode_partials(q, k, v, ln, splits=8, chunk=128)
    n0 = dict(tdk.LAUNCHES)
    out = tdk.paged_decode_merge(ml, acc, dtype)
    torch.cuda.synchronize()
    assert tdk.LAUNCHES["paged_decode_attention_merge"] == n0["paged_decode_attention_merge"] + 1
    assert tdk.LAUNCHES["spec_tail_attention_merge"] == n0["spec_tail_attention_merge"]
    ref = tdk.spec_tail_merge_plain(ml, acc, 1, dtype).reshape(S, Kh * rep, D).float()
    assert bool((ml[..., 0] == float("-inf")).any())  # slot 0 leaves 7 splits dead
    tol = {torch.float32: 1e-6, torch.bfloat16: 2.0**-8, torch.float16: 2.0**-8 * F16}[dtype] * max(
        1.0, float(ref.abs().max()))
    assert float((out.float() - ref).abs().max()) <= tol


@pytest.mark.cuda
def test_paged_decode_attention_routes(cuda):
    """Head dims up to 128 take the split kernel, above 128 the first
    design (counted as paged_decode_attention_first)."""
    for D in (64, 128, 136, 256):
        q, k, v, ln = _attn_inputs(cuda, 2, 96, 2, 3, D, torch.bfloat16, [95, 5])
        n0 = dict(tdk.LAUNCHES)
        out = tdk.paged_decode_attention(q, k, v, ln)
        torch.cuda.synchronize()
        name = "paged_decode_attention" if D <= 128 else "paged_decode_attention_first"
        other = "paged_decode_attention_first" if D <= 128 else "paged_decode_attention"
        assert tdk.LAUNCHES[name] == n0[name] + 1 and tdk.LAUNCHES[other] == n0[other]
        ref = tdk.paged_decode_attention_plain(q, k, v, ln).float()
        tol = 2.0**-6 * ref.abs().amax(dim=(1, 2))
        assert bool(((out.float() - ref).abs().amax(dim=(1, 2)) <= tol).all())


@pytest.mark.cuda
@pytest.mark.parametrize(
    "bad",
    [
        dict(D=12),  # not a multiple of 8
        dict(D=264),  # above 256
        dict(H=6),  # 6 query heads over 4 kv heads
        dict(dtype=torch.float64),  # no kernel instance (f32, bf16 and f16 have one)
    ],
)
def test_paged_decode_attention_rejects(cuda, bad):
    D, H, dtype = bad.get("D", 64), bad.get("H", 8), bad.get("dtype", torch.float32)
    q = torch.zeros(2, H, D, device=cuda, dtype=dtype)
    k = torch.zeros(2, 16, 4, D, device=cuda, dtype=dtype)
    lens = torch.zeros(2, dtype=torch.int32, device=cuda)
    n0 = dict(tdk.LAUNCHES)
    with pytest.raises(ValueError):
        tdk.paged_decode_attention(q, k, k, lens)
    assert tdk.LAUNCHES == n0


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


# the config_1b layer's shapes, then K not a multiple of 16, one column tile
# and a short K
SM90_W4_SHAPES = [(2048, 2048), (2048, 256), (2048, 5632), (5632, 2048), (200, 64), (64, 128), (24, 320)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SM90_W4_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("M", [1, 8, 40, 100, 1024])
def test_w4_matmul_sm90_matches_plain_and_repeats(cuda, shape, M):
    """The sm90 B8 (bf16) against its plain version: both sum in f32 and
    round once to bf16, so 2**-7 of the largest output; bit for bit on a
    second launch; counted under its own name; its tickets back at 0."""
    K, N = shape
    q, s, g = _packed(cuda, K, N, seed=K + N + M)
    x = torch.randn(M, K, generator=g, device=cuda).to(torch.bfloat16)
    n0 = dict(tdk.LAUNCHES)
    out = tdk.w4_matmul(x, q, s, shape, torch.bfloat16)
    torch.cuda.synchronize()
    assert tdk.LAUNCHES["w4_matmul_sm90"] == n0["w4_matmul_sm90"] + 1
    assert tdk.LAUNCHES["w4_matmul"] == n0["w4_matmul"]
    assert out.dtype == torch.bfloat16 and out.shape == (M, N)
    assert torch.equal(out, tdk.w4_matmul(x, q, s, shape, torch.bfloat16))
    ref = tdk.w4_matmul_plain(x, q, s, shape, torch.bfloat16).float()
    assert float((out.float() - ref).abs().max()) <= 2**-7 * float(ref.abs().max())
    bufs = tdk._w4_scratch_bufs.get((out.device.index, torch.cuda.current_stream().cuda_stream))
    assert bufs is None or not bool(bufs[3].any())


def _w4_sm90_at(x, q, s, K, N, splits):
    """The sm90 B8's C entry at a forced split count, with scratch of its
    own: (out, tickets after the launch)."""
    M = x.shape[0]
    out = torch.empty(M, N, dtype=torch.bfloat16, device=x.device)
    part = torch.empty(max(1, splits * M * N), dtype=torch.float32, device=x.device)
    tickets = torch.zeros(-(-M // (16 * tdk.w4_slices(M))) * (N // tdk.W4_TILE_N), dtype=torch.int32,
                          device=x.device)
    tdk._launch("w4_matmul_sm90", torch.bfloat16, x.device, x.data_ptr(), q.data_ptr(), s.data_ptr(),
                out.data_ptr(), part.data_ptr(), tickets.data_ptr(), M, K, N, tdk.w4_slices(M), splits)
    return out, tickets


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SM90_W4_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_w4_matmul_sm90_forced_splits_cover_k(cuda, shape):
    """The kernel's own cut of K: at split counts that do and do not divide
    its 16-row steps, up to one step a split, every split count agrees with
    the plain version (2**-7 of the largest output) and leaves its tickets
    at 0."""
    K, N = shape
    q, s, g = _packed(cuda, K, N, seed=K + 3 * N)
    ksteps = -(-K // 16)
    for M in (8, 40):
        x = torch.randn(M, K, generator=g, device=cuda).to(torch.bfloat16)
        ref = tdk.w4_matmul_plain(x, q, s, shape, torch.bfloat16).float()
        for splits in sorted({1, 2, 3, 7, max(1, ksteps // 3), max(1, ksteps - 1), ksteps}):
            if splits > ksteps:
                continue
            out, tickets = _w4_sm90_at(x, q, s, K, N, splits)
            torch.cuda.synchronize()
            err = float((out.float() - ref).abs().max())
            assert err <= 2**-7 * float(ref.abs().max()), (M, splits, err)
            assert not bool(tickets.any()), (M, splits)


@pytest.mark.cuda
def test_w4_matmul_graph_keeps_its_scratch(cuda):
    """A graph captured on a stream keeps that stream's scratch: calls at a
    larger shape after the capture (a prefill's 1024 rows through the 2048
    x 256 weight take more partials than decode's 8) move nothing, and the
    replay gives the bits the eager call gave."""
    K, N = 2048, 256
    q, s, g = _packed(cuda, K, N, seed=21)
    x = torch.randn(8, K, generator=g, device=cuda).to(torch.bfloat16)
    big = torch.randn(1024, K, generator=g, device=cuda).to(torch.bfloat16)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        want = tdk.w4_matmul(x, q, s, (K, N), torch.bfloat16)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    before = dict(tdk._w4_scratch_bufs)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        got = tdk.w4_matmul(x, q, s, (K, N), torch.bfloat16)
    for stream in (torch.cuda.current_stream(), side):
        with torch.cuda.stream(stream):
            wide = tdk.w4_matmul(big, q, s, (K, N), torch.bfloat16)
        torch.cuda.synchronize()
        ref = tdk.w4_matmul_plain(big, q, s, (K, N), torch.bfloat16).float()
        assert float((wide.float() - ref).abs().max()) <= 2**-7 * float(ref.abs().max())
    for key, bufs in before.items():
        assert tdk._w4_scratch_bufs[key][:2] == bufs[:2]
    got.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_w4_matmul_two_streams_keep_their_bits(cuda):
    """Split launches on two streams at once use a scratch each: 20 rounds
    of calls issued on both streams with no wait between them give the bits
    of one call on one stream."""
    K, N = 2048, 256
    q, s, g = _packed(cuda, K, N, seed=22)
    xs = [torch.randn(8, K, generator=g, device=cuda).to(torch.bfloat16) for _ in range(2)]
    want = [tdk.w4_matmul(x, q, s, (K, N), torch.bfloat16) for x in xs]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream() for _ in range(2)]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    outs = [[], []]
    for _ in range(20):
        for i, st in enumerate(streams):
            with torch.cuda.stream(st):
                outs[i].append(tdk.w4_matmul(xs[i], q, s, (K, N), torch.bfloat16))
    torch.cuda.synchronize()
    for i in range(2):
        assert all(torch.equal(o, want[i]) for o in outs[i]), i


@pytest.mark.cuda
def test_w4_matmul_routes(cuda):
    """bf16 at N a multiple of 64 takes the sm90 kernel, other shapes and
    f32 the first design; the sm90 route forced on f32 raises and launches
    nothing."""
    q, s, g = _packed(cuda, 64, 96, seed=5)
    x = torch.randn(8, 64, generator=g, device=cuda)
    n0 = dict(tdk.LAUNCHES)
    tdk.w4_matmul(x, q, s, (64, 96), torch.bfloat16)  # 96 columns: the first design
    torch.cuda.synchronize()
    assert tdk.LAUNCHES["w4_matmul"] == n0["w4_matmul"] + 1
    with pytest.raises(ValueError):
        tdk.w4_matmul(x, q, s, (64, 96), torch.bfloat16, route=tdk.W4_SM90_SOURCE)
    q, s, _ = _packed(cuda, 64, 128, seed=6)
    with pytest.raises(ValueError):
        tdk.w4_matmul(x, q, s, (64, 128), torch.float32, route=tdk.W4_SM90_SOURCE)
    assert tdk.LAUNCHES["w4_matmul_sm90"] == n0["w4_matmul_sm90"]
    first = tdk.w4_matmul(x, q, s, (64, 128), torch.bfloat16, route=tdk.W4_FIRST_SOURCE)
    sm90 = tdk.w4_matmul(x, q, s, (64, 128), torch.bfloat16)
    torch.cuda.synchronize()
    assert tdk.LAUNCHES["w4_matmul_sm90"] == n0["w4_matmul_sm90"] + 1
    assert float((first.float() - sm90.float()).abs().max()) <= 2**-6 * float(first.float().abs().max())


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
    output, two to four bf16 ulps there. f16 likewise at 2**-9."""
    ref = ref.float()
    if dtype == torch.float32:
        return torch.full(ref.shape[:1] + ref.shape[2:3], 1e-5 * max(1.0, float(ref.abs().max())),
                          device=ref.device)
    return ATTN_SHARE[dtype] * ref.abs().amax(dim=(1, 3))


def _flash_err(out, ref):
    """Per (batch, head) max |out - ref| of [B, T, H, D] tensors."""
    return (out.float() - ref.float()).abs().amax(dim=(1, 3))


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
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
    # both directions share one route rule; delta has one kernel for both
    sfx = "_sm90" if tfa._bwd_route(dtype, D) == tfa.SM90_SOURCE else ""
    for name in ("flash_attention_fwd" + sfx, "flash_attention_dq" + sfx, "flash_attention_dkv" + sfx,
                 "flash_attention_delta"):
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


# bf16 geometries of the sm90 forward and backward (wgmma, TMA): D 32, 64
# and 128; rep 1 and 8 (the 1b heads); T ragged against the 128- and 64-row
# tiles, a single tile, and a long sequence
SM90_GEOMS = [
    # B, T, H, Hkv, D
    (1, 200, 4, 4, 32),
    (2, 1000, 8, 1, 32),
    (1, 200, 4, 4, 64),
    (2, 1000, 16, 2, 64),
    (2, 64, 8, 1, 64),
    (1, 1024, 32, 4, 64),
    (8, 1024, 32, 4, 64),  # what config_1b training launches: ~16 q tiles a CTA on B1's ring
    (1, 200, 4, 4, 128),
    (1, 1000, 8, 1, 128),
    (1, 64, 2, 2, 128),
]


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("geom", SM90_GEOMS, ids=lambda g: "x".join(map(str, g)))
def test_flash_attention_sm90_backward_matches_plain(cuda, geom, causal):
    # the sm90 forward (out, lse) and backward (dq, dk, dv) against the
    # plain versions; the backward reads the plain lse and delta
    from opendiloco_torch.ops import flash_attention as tfa

    B, T, H, Hkv, D = geom
    q, k, v, do = _flash_inputs(cuda, *geom, torch.bfloat16, seed=3)
    out, lse = tfa.flash_attention_fwd_plain(q, k, v, causal)
    delta = tfa.attention_delta(do, out)
    n0 = dict(tdk.LAUNCHES)
    got_out, got_lse = tfa.flash_attention_fwd(q, k, v, causal)
    dq = tfa.flash_attention_dq(q, k, v, do, lse, delta, causal)
    dk, dv = tfa.flash_attention_dkv(q, k, v, do, lse, delta, causal)
    torch.cuda.synchronize()
    for name in ("flash_attention_fwd_sm90", "flash_attention_dq_sm90", "flash_attention_dkv_sm90"):
        assert tdk.LAUNCHES[name] == n0[name] + 1
    assert got_lse.dtype == torch.float32 and got_lse.shape == (B, H, T)
    # lse: f32 statistics in both, ex2.approx and another order of sums
    lse_err = float((got_lse - lse).abs().max())
    assert lse_err <= 1e-4 * max(1.0, float(lse.abs().max())), lse_err
    ref_dq = tfa.flash_attention_dq_plain(q, k, v, do, lse, delta, causal)
    ref_dk, ref_dv = tfa.flash_attention_dkv_plain(q, k, v, do, lse, delta, causal)
    for name, got, ref in (("out", got_out, out), ("dq", dq, ref_dq), ("dk", dk, ref_dk), ("dv", dv, ref_dv)):
        assert got.dtype == torch.bfloat16 and got.shape == ref.shape
        err, tol = _flash_err(got, ref), _flash_tol(ref, torch.bfloat16)
        print(f"{name} {geom} causal={causal}: max err/tol {float((err / tol).max()):.3f}")
        assert bool((err <= tol).all()), f"{name}: per-head error {err.tolist()} over {tol.tolist()}"


DELTA_GEOMS = [
    # B, T, H, D
    (8, 1024, 32, 64),  # the 1b head geometry
    (2, 1000, 16, 64),  # odd T
    (1, 100, 3, 8),  # D 8: one 16-byte chunk a row in bf16
    (2, 70, 4, 40),  # D 40: a row of 5 (bf16) or 10 (f32) chunks in a group of 8 or 16 lanes
    (1, 130, 2, 128),  # D 128: 32 lanes a row in f32
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("geom", DELTA_GEOMS, ids=lambda g: "x".join(map(str, g)))
def test_attention_delta_kernel_matches_plain(cuda, geom, dtype):
    """The delta kernel against the plain body: f32 sums of D products (in
    bf16 and f16 exact in f32) in another order, 1e-6 of the largest
    |delta|."""
    from opendiloco_torch.ops import flash_attention as tfa

    B, T, H, D = geom
    g = torch.Generator(device=cuda).manual_seed(B * T + D)
    do, out = (torch.randn(B, T, H, D, generator=g, device=cuda).to(dtype) for _ in range(2))
    n0 = tdk.LAUNCHES["flash_attention_delta"]
    delta = tfa.attention_delta(do, out)
    torch.cuda.synchronize()
    assert tdk.LAUNCHES["flash_attention_delta"] == n0 + 1
    ref = tfa.attention_delta_plain(do, out)
    assert delta.dtype == torch.float32 and delta.shape == (B, H, T) and delta.is_contiguous()
    err = float((delta - ref).abs().max())
    print(f"delta {geom} {dtype}: max err {err:.2e} of {float(ref.abs().max()):.2f}")
    assert err <= 1e-6 * float(ref.abs().max())
    assert torch.equal(delta, tfa.attention_delta(do, out))  # a fixed order: the same bits


@pytest.mark.cuda
@pytest.mark.parametrize(
    "bad",
    [
        dict(D=12),  # not a multiple of 8
        dict(D=136),  # above 128
        dict(dtype=torch.float64),  # no kernel instance (f32, bf16 and f16 have one)
        dict(strided=True),  # not contiguous
        dict(mixed=True),  # dO and O in two dtypes
    ],
)
def test_attention_delta_rejects(cuda, bad):
    from opendiloco_torch.ops import flash_attention as tfa

    D, dtype = bad.get("D", 64), bad.get("dtype", torch.float32)
    out = torch.zeros(2, 32, 4, D, device=cuda, dtype=dtype)
    if bad.get("strided"):
        out = torch.zeros(2, 4, 32, D, device=cuda, dtype=dtype).transpose(1, 2)
    do = out.to(torch.bfloat16) if bad.get("mixed") else out
    n0 = dict(tdk.LAUNCHES)
    with pytest.raises(ValueError):
        tfa.attention_delta(do, out)
    assert tdk.LAUNCHES == n0


@pytest.mark.cuda
def test_flash_attention_backward_routes_count_their_own_launches(cuda):
    # bf16 at D 64 takes the sm90 kernels of both directions and never the
    # first design's; f32 at D 64 and bf16 at D 40 take the first design's,
    # which route= also reaches in bf16. delta has one kernel for all.
    from opendiloco_torch.ops import flash_attention as tfa

    names = ("flash_attention_fwd", "flash_attention_dq", "flash_attention_dkv", "flash_attention_fwd_sm90",
             "flash_attention_dq_sm90", "flash_attention_dkv_sm90", "flash_attention_delta")
    first, sm90 = (1, 1, 1, 0, 0, 0, 1), (0, 0, 0, 1, 1, 1, 1)
    for dtype, D, route, want in ((torch.bfloat16, 64, None, sm90), (torch.float32, 64, None, first),
                                  (torch.bfloat16, 40, None, first), (torch.bfloat16, 64, tfa.SOURCE, first)):
        q, k, v, do = _flash_inputs(cuda, 1, 128, 4, 2, D, dtype)
        n0 = dict(tdk.LAUNCHES)
        if route is None:
            out, lse = tfa.flash_attention_fwd(q, k, v)
            delta = tfa.attention_delta(do, out)
            tfa.flash_attention_dq(q, k, v, do, lse, delta)
            tfa.flash_attention_dkv(q, k, v, do, lse, delta)
        else:
            out, lse = tfa._fwd_kernel(q, k, v, True, route=route)
            delta = tfa.attention_delta(do, out)
            tfa._dq_kernel(q, k, v, do, lse, delta, True, None, route=route)
            tfa._dkv_kernel(q, k, v, do, lse, delta, True, None, route=route)
        torch.cuda.synchronize()
        assert tuple(tdk.LAUNCHES[n] - n0[n] for n in names) == want, (dtype, D, route)


@pytest.mark.cuda
def test_a_fresh_thread_launches_the_kernels(cuda):
    """A thread that has run no PyTorch op on the card launches B1 and the
    backward kernels as the main thread does (the loopback ring's ranks:
    ROADMAP.md C7), with the same bits."""
    import threading

    from opendiloco_torch.ops import flash_attention as tfa

    q, k, v, do = _flash_inputs(cuda, 2, 256, 4, 2, 64, torch.bfloat16)

    def run():
        out, lse = tfa.flash_attention_fwd(q, k, v)
        delta = tfa.attention_delta(do, out)
        return [out, lse, tfa.flash_attention_dq(q, k, v, do, lse, delta, False, torch.float32)]

    main, got = run(), []
    thread = threading.Thread(target=lambda: got.extend(run()))
    thread.start()
    thread.join()
    torch.cuda.synchronize()
    assert len(got) == 3 and all(torch.equal(a, b) for a, b in zip(got, main))


def test_flash_attention_backward_route_rule():
    # dtype and head dim alone decide; runs without a card
    from opendiloco_torch.ops import flash_attention as tfa

    for D in (32, 64, 128):
        assert tfa._bwd_route(torch.bfloat16, D) == tfa.SM90_SOURCE == "flash_attention_bwd_sm90"
        assert tfa._bwd_route(torch.float32, D) == tfa.SOURCE == "flash_attention"
    for D in (8, 16, 40, 48, 96, 120):
        assert tfa._bwd_route(torch.bfloat16, D) == tfa.SOURCE


def test_flash_attention_forward_route_rule_agrees_with_backward():
    # the forward takes the sm90 kernel exactly where the backward does;
    # runs without a card
    from opendiloco_torch.ops import flash_attention as tfa

    for D in (32, 64, 128):
        assert tfa._fwd_route(torch.bfloat16, D) == tfa.SM90_FWD_SOURCE == "flash_attention_fwd_sm90"
        assert tfa._fwd_route(torch.float32, D) == tfa.SOURCE
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for D in (8, 16, 32, 40, 48, 64, 96, 120, 128):
            on_sm90 = (tfa._fwd_route(dtype, D) == tfa.SM90_FWD_SOURCE,
                       tfa._bwd_route(dtype, D) == tfa.SM90_SOURCE)
            assert on_sm90[0] == on_sm90[1] == tfa._on_sm90(dtype, D), (dtype, D)
            if not on_sm90[0]:
                assert tfa._fwd_route(dtype, D) == tfa._bwd_route(dtype, D) == tfa.SOURCE


@pytest.mark.cuda
@pytest.mark.parametrize("geom", [(2, 512, 8, 2, 64), (2, 1024, 32, 4, 64), (8, 1024, 32, 4, 64)],
                         ids=["rep4", "1b-heads", "1b-train"])
def test_flash_attention_kernels_repeat_bitwise(cuda, geom):
    from opendiloco_torch.ops import flash_attention as tfa

    q, k, v, do = _flash_inputs(cuda, *geom, torch.bfloat16)
    n0 = dict(tdk.LAUNCHES)
    runs = []
    for _ in range(2):
        out, lse = tfa.flash_attention_fwd(q, k, v, True)
        delta = tfa.attention_delta(do, out)
        runs.append((out, lse, delta, tfa.flash_attention_dq(q, k, v, do, lse, delta),
                     *tfa.flash_attention_dkv(q, k, v, do, lse, delta)))
    # bf16 at D 64: every kernel of the sm90 route, and the delta kernel
    for name in ("flash_attention_fwd_sm90", "flash_attention_delta", "flash_attention_dq_sm90",
                 "flash_attention_dkv_sm90"):
        assert tdk.LAUNCHES[name] == n0[name] + 2
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
@pytest.mark.parametrize("geom", [(2, 300, 8, 2, 64), (1, 256, 4, 4, 128)], ids=["rep4-D64", "D128"])
def test_flash_attention_bf16_autograd_matches_plain_chain(cuda, geom):
    """bf16 through ``flash_attention`` (the sm90 forward, the delta
    kernel, the sm90 backward) against the plain versions chained on the
    same inputs (plain forward, plain delta, plain dq and dk/dv). The two
    sides round p and the outputs at points that differ by f32 rounding,
    and the plain side's delta reads its own out: 2**-6 of each head's
    largest value, as the kernel checks."""
    from opendiloco_torch.ops import flash_attention as tfa

    q, k, v, do = _flash_inputs(cuda, *geom, torch.bfloat16, seed=7)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    n0 = dict(tdk.LAUNCHES)
    out = tfa.flash_attention(*leaves, causal=True)
    out.backward(do)
    torch.cuda.synchronize()
    for name in ("flash_attention_fwd_sm90", "flash_attention_delta", "flash_attention_dq_sm90",
                 "flash_attention_dkv_sm90"):
        assert tdk.LAUNCHES[name] == n0[name] + 1
    ref_out, ref_lse = tfa.flash_attention_fwd_plain(q, k, v, True)
    delta = tfa.attention_delta_plain(do, ref_out)
    ref_dq = tfa.flash_attention_dq_plain(q, k, v, do, ref_lse, delta, True)
    ref_dk, ref_dv = tfa.flash_attention_dkv_plain(q, k, v, do, ref_lse, delta, True)
    for name, got, ref in (("out", out.detach(), ref_out), ("dq", leaves[0].grad, ref_dq),
                           ("dk", leaves[1].grad, ref_dk), ("dv", leaves[2].grad, ref_dv)):
        assert got.dtype == torch.bfloat16 and got.shape == ref.shape
        err, tol = _flash_err(got, ref), _flash_tol(ref, torch.bfloat16)
        print(f"autograd {name} {geom}: max err/tol {float((err / tol).max()):.3f}")
        assert bool((err <= tol).all()), f"{name}: per-head error {err.tolist()} over {tol.tolist()}"


@pytest.mark.cuda
@pytest.mark.parametrize(
    "bad",
    [
        dict(D=12),  # not a multiple of 8
        dict(D=136),  # above 128
        dict(H=6),  # 6 query heads over 4 kv heads
        dict(dtype=torch.float64),  # no kernel instance (f32, bf16 and f16 have one)
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


# ---------------------------------------------------------------------------
# fused lm-head + cross-entropy: B3, B4a, B4b and the dlog kernel
# ---------------------------------------------------------------------------

XENT_GEOMS = [
    # N, D, V
    (512, 128, 512),  # the CPU parity width
    (1000, 1024, 1000),  # the 150m width; odd N and V
    (8184, 2048, 32000),  # the 1b training shape
    (37, 8, 8),  # the smallest sizes the kernels take
]


def _xent_inputs(dev, N, D, V, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed + N + D + V)
    h = torch.randn(N, D, generator=g, device=dev).to(dtype)
    w = (0.02 * torch.randn(D, V, generator=g, device=dev)).to(dtype)
    labels = torch.randint(0, V, (N,), generator=g, device=dev)
    labels[::7] = -100
    mask = labels != -100
    gup = mask.float() / max(1, int(mask.sum()))
    return h, w, labels, gup


def _rel_err(got, ref):
    return float((got.float() - ref.float()).abs().max()) / max(float(ref.float().abs().max()), 1e-30)


def _share_of_limit(got, ref, rtol, atol):
    """The worst element's |got - ref| over its limit rtol |ref| + atol."""
    ref = ref.float()
    return float(((got.float() - ref).abs() / (rtol * ref.abs() + atol)).max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("geom", XENT_GEOMS, ids=lambda g: "x".join(map(str, g)))
def test_fused_xent_kernels_match_plain(cuda, geom, dtype):
    """Each kernel against its plain version on the same inputs. The logits
    are exact products summed in f32 on both sides (bf16 x bf16 is exact in
    f32), so nll and lse agree to 1e-4 of the largest lse whatever the
    dtype. dlog is held element by element: rtol 2**-7 in bf16 (it rounds
    once, and an f32 value at a rounding boundary may land one ulp apart)
    and 1e-5 in f32 (D-long sums in another order), plus an atol of rtol/2
    of an average softmax entry, max(g) / V, so that a wrong non-target
    entry fails. dh in bf16 likewise: rtol 2**-7, plus 1e-5 of its largest
    value for elements that nearly cancel. In f32, dh sums V terms (32000
    at 1b) in another order, about 2**-24 * sqrt(V) = 1e-5 of the result
    (measured 1.01e-5 at 1b), so 1e-4 of its largest value. dw is f32 from
    rows-long f32 sums in another order: 1e-5 of its largest value. f16
    takes the sm90 kernels too, with bf16's limits over 8, and an upstream
    gradient times 2**15, the loss scale fp16-mixed starts at (unscaled,
    dlog would sit in f16's subnormals, where one ulp is most of a value)."""
    from opendiloco_torch.ops import fused_xent as tfx

    N, D, V = geom
    h, w, labels, gup = _xent_inputs(cuda, N, D, V, dtype)
    if dtype == torch.float16:
        gup = gup * 2.0**15
    n0 = dict(tdk.LAUNCHES)
    nll, lse = tfx.fused_xent_fwd(h, w, labels)
    ref_nll, ref_lse = tfx.fused_xent_fwd_plain(h, w, labels)
    rows = slice(0, min(N, tfx.CHUNK_ROWS))
    args = (h[rows], w, labels[rows], ref_lse[rows], gup[rows])
    dlog = tfx.fused_xent_dlog(*args)
    ref_dlog = tfx.fused_xent_dlog_plain(*args)
    dh = tfx.fused_xent_dh(ref_dlog, w)
    dw = tfx.fused_xent_dw(h[rows], ref_dlog)
    torch.cuda.synchronize()
    # bf16 and f16 take the sm90 kernels, f32 the first design
    sfx = "_sm90" if dtype != torch.float32 else ""
    for name in ("fused_xent_fwd" + sfx, "fused_xent_dlog" + sfx, "fused_xent_dh" + sfx, "fused_xent_dw" + sfx):
        assert tdk.LAUNCHES[name] == n0[name] + 1
    assert nll.dtype == lse.dtype == torch.float32 and nll.shape == lse.shape == (N,)
    assert dlog.dtype == dh.dtype == dtype and dw.dtype == torch.float32
    assert not bool(nll[labels == -100].any())
    scale = max(1.0, float(ref_lse.abs().max()))
    assert float((lse - ref_lse).abs().max()) <= 1e-4 * scale
    assert float((nll - ref_nll).abs().max()) <= 1e-4 * scale
    half = dtype != torch.float32
    scaled = F16 if dtype == torch.float16 else 1.0
    r = 2.0**-7 * scaled if half else 1e-5
    assert _share_of_limit(dlog, ref_dlog, r, r / 2 * float(gup.max()) / V) <= 1.0
    ref_dh = tfx.fused_xent_dh_plain(ref_dlog, w)
    if half:
        assert _share_of_limit(dh, ref_dh, r, 1e-5 * scaled * float(ref_dh.float().abs().max())) <= 1.0
    else:
        assert _rel_err(dh, ref_dh) <= 1e-4
    assert _rel_err(dw, tfx.fused_xent_dw_plain(h[rows], ref_dlog)) <= 1e-5
    # dw accumulates in place: a second chunk adds its share to the first
    assert tfx.fused_xent_dw(h[rows], ref_dlog, dw) is dw
    assert _rel_err(dw, 2 * tfx.fused_xent_dw_plain(h[rows], ref_dlog)) <= 1e-5


@pytest.mark.cuda
def test_fused_xent_kernels_repeat_bitwise(cuda):
    from opendiloco_torch.ops import fused_xent as tfx

    h, w, labels, gup = _xent_inputs(cuda, 4100, 256, 4000, torch.bfloat16)  # three backward chunks
    runs = []
    n0 = dict(tdk.LAUNCHES)
    for _ in range(2):
        nll, lse = tfx.fused_xent_fwd(h, w, labels)
        runs.append((nll, lse, *tfx.fused_xent_bwd(h, w, labels, lse, gup)))
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    # bf16 took the sm90 kernels (the route under test): B3 once a run, dlog,
    # dh and dw for each of 3 chunks a run
    for name in tfx.SM90_NAMES:
        assert tdk.LAUNCHES[name] == n0[name] + (2 if name == "fused_xent_fwd_sm90" else 6)
    for name in tfx.NAMES:
        assert tdk.LAUNCHES[name] == n0[name]


# (N, D, V): the 1b chunk, the ragged last chunk of 8184 rows, a small and
# ragged vocab, the 150m width
SM90_XENT_GEOMS = [(2048, 2048, 32000), (2040, 2048, 32000), (2048, 2048, 1000), (2040, 1024, 32000)]


@pytest.mark.cuda
@pytest.mark.parametrize("geom", SM90_XENT_GEOMS, ids=lambda g: "x".join(map(str, g)))
def test_fused_xent_sm90_dlog_dh_match_plain_and_repeat(cuda, geom):
    """The sm90 dlog and dh against their plain versions, with the element
    tolerances of test_fused_xent_kernels_match_plain in bf16, and against
    the first design's kernels within the same limits; each repeats bit
    for bit."""
    from opendiloco_torch.ops import fused_xent as tfx

    N, D, V = geom
    h, w, labels, gup = _xent_inputs(cuda, N, D, V, torch.bfloat16)
    _, lse = tfx.fused_xent_fwd_plain(h, w, labels)
    args = (h, w, labels, lse, gup)
    n0 = dict(tdk.LAUNCHES)
    dlog = tfx.fused_xent_dlog(*args)
    again = tfx.fused_xent_dlog(*args)
    first = tfx.fused_xent_dlog(*args, route=tfx.SOURCE)
    ref_dlog = tfx.fused_xent_dlog_plain(*args)
    dh = tfx.fused_xent_dh(ref_dlog, w)
    dh_again = tfx.fused_xent_dh(ref_dlog, w)
    dh_first = tfx.fused_xent_dh(ref_dlog, w, route=tfx.SOURCE)
    torch.cuda.synchronize()
    assert tdk.LAUNCHES["fused_xent_dlog_sm90"] == n0["fused_xent_dlog_sm90"] + 2
    assert tdk.LAUNCHES["fused_xent_dh_sm90"] == n0["fused_xent_dh_sm90"] + 2
    assert tdk.LAUNCHES["fused_xent_dlog"] == n0["fused_xent_dlog"] + 1
    assert tdk.LAUNCHES["fused_xent_dh"] == n0["fused_xent_dh"] + 1
    assert dlog.dtype == dh.dtype == torch.bfloat16 and dlog.shape == (N, V) and dh.shape == (N, D)
    assert torch.equal(dlog, again) and torch.equal(dh, dh_again)
    r = 2.0**-7
    atol = r / 2 * float(gup.max()) / V
    for got in (dlog, first):
        assert _share_of_limit(got, ref_dlog, r, atol) <= 1.0
    ref_dh = tfx.fused_xent_dh_plain(ref_dlog, w)
    for got in (dh, dh_first):
        assert _share_of_limit(got, ref_dh, r, 1e-5 * float(ref_dh.float().abs().max())) <= 1.0
    print(f"sm90 {geom}: dlog share {_share_of_limit(dlog, ref_dlog, r, atol):.3f}, dh share "
          f"{_share_of_limit(dh, ref_dh, r, 1e-5 * float(ref_dh.float().abs().max())):.3f}")


@pytest.mark.cuda
@pytest.mark.parametrize("N", [2048, 2040, 1000])
def test_fused_xent_dw_sm90_matches_plain_and_repeats(cuda, N):
    """The sm90 dw at the 1b chunk shape (D 2048, V 32000), a full chunk,
    the ragged last one and a short one (TMA zero-fills both operands' rows
    past N), written and then added to a prior dw: against the plain
    version within 1e-5 of the largest |dw| (f32 sums over N rows in
    another order), the first design within the same limit, bit for bit on
    a second launch and a second add."""
    from opendiloco_torch.ops import fused_xent as tfx

    D, V = 2048, 32000
    h, w, labels, gup = _xent_inputs(cuda, N, D, V, torch.bfloat16)
    _, lse = tfx.fused_xent_fwd_plain(h, w, labels)
    dlog = tfx.fused_xent_dlog_plain(h, w, labels, lse, gup)
    base = torch.randn(D, V, generator=torch.Generator(device=cuda).manual_seed(N), device=cuda) * 1e-3
    n0 = dict(tdk.LAUNCHES)
    dw = tfx.fused_xent_dw(h, dlog)
    again = tfx.fused_xent_dw(h, dlog)
    acc, acc2 = base.clone(), base.clone()
    tfx.fused_xent_dw(h, dlog, acc)
    tfx.fused_xent_dw(h, dlog, acc2)
    first = tfx.fused_xent_dw(h, dlog, route=tfx.SOURCE)
    torch.cuda.synchronize()
    assert tdk.LAUNCHES["fused_xent_dw_sm90"] == n0["fused_xent_dw_sm90"] + 4
    assert tdk.LAUNCHES["fused_xent_dw"] == n0["fused_xent_dw"] + 1
    assert torch.equal(dw, again) and torch.equal(acc, acc2)
    ref = tfx.fused_xent_dw_plain(h, dlog)
    top = float(ref.abs().max())
    for got, want in ((dw, ref), (first, ref), (acc, base + ref)):
        assert float((got - want).abs().max()) <= 1e-5 * top
    print(f"sm90 dw N{N}: max err {float((dw - ref).abs().max()) / top:.2e} of the largest |dw|")


# (N, D, V): the 1b forward, its 150m width, a ragged vocab (masked columns
# in the last tile), one vocab tile (one split), a small N
SM90_FWD_GEOMS = [(8184, 2048, 32000), (8184, 1024, 32000), (1000, 1024, 1000), (4096, 256, 256), (300, 256, 4000)]


@pytest.mark.cuda
@pytest.mark.parametrize("geom", SM90_FWD_GEOMS, ids=lambda g: "x".join(map(str, g)))
def test_fused_xent_fwd_sm90_matches_plain_and_repeats(cuda, geom):
    """The sm90 B3 against its plain version and the first design (through
    route=) with test_fused_xent_kernels_match_plain's limits (nll and lse
    within 1e-4 of the largest lse), no loss on an ignored row, bit for
    bit on a second launch, one launch counted under its own name."""
    from opendiloco_torch.ops import fused_xent as tfx

    N, D, V = geom
    h, w, labels, _ = _xent_inputs(cuda, N, D, V, torch.bfloat16)
    n0 = dict(tdk.LAUNCHES)
    nll, lse = tfx.fused_xent_fwd(h, w, labels)
    torch.cuda.synchronize()
    assert tdk.LAUNCHES["fused_xent_fwd_sm90"] == n0["fused_xent_fwd_sm90"] + 1
    assert tdk.LAUNCHES["fused_xent_fwd"] == n0["fused_xent_fwd"]
    again = tfx.fused_xent_fwd(h, w, labels)
    assert torch.equal(nll, again[0]) and torch.equal(lse, again[1])
    assert not bool(nll[labels == -100].any())
    ref_nll, ref_lse = tfx.fused_xent_fwd_plain(h, w, labels)
    first = tfx.fused_xent_fwd(h, w, labels, route=tfx.SOURCE)
    scale = max(1.0, float(ref_lse.abs().max()))
    for ref in ((ref_nll, ref_lse), first):
        assert float((lse - ref[1]).abs().max()) <= 1e-4 * scale
        assert float((nll - ref[0]).abs().max()) <= 1e-4 * scale
    print(f"sm90 B3 {geom}: {tfx.fwd_sm90_splits(N, V, torch.cuda.get_device_properties(cuda).multi_processor_count)} "
          f"splits, lse err {float((lse - ref_lse).abs().max()):.2e}")


@pytest.mark.cuda
@pytest.mark.parametrize("geom", [(1000, 256, 4000), (300, 512, 32000)], ids=lambda g: "x".join(map(str, g)))
def test_fused_xent_fwd_sm90_forced_splits_cover_the_vocab(cuda, geom):
    """The kernel's own cut of the vocab: at split counts that do and do not
    divide its 256-column tiles, up to one tile a split, nll and lse agree
    with the plain version within 1e-4 of the largest lse."""
    from opendiloco_torch.ops import fused_xent as tfx

    N, D, V = geom
    h, w, labels, _ = _xent_inputs(cuda, N, D, V, torch.bfloat16)
    ref_nll, ref_lse = tfx.fused_xent_fwd_plain(h, w, labels)
    scale = max(1.0, float(ref_lse.abs().max()))
    nvt = -(-V // 256)
    for splits in sorted({1, 2, 3, 7, nvt // 2, nvt - 1, nvt}):
        nll = torch.empty(N, dtype=torch.float32, device=cuda)
        lse = torch.empty(N, dtype=torch.float32, device=cuda)
        part = torch.empty((3, splits, N) if splits > 1 else (1,), dtype=torch.float32, device=cuda)
        tfx._launch("fused_xent_fwd", h.dtype, h.device, h.data_ptr(), w.data_ptr(), labels.data_ptr(),
                    nll.data_ptr(), lse.data_ptr(), part.data_ptr(), N, D, V, splits, source=tfx.SM90_SOURCE)
        torch.cuda.synchronize()
        assert float((lse - ref_lse).abs().max()) <= 1e-4 * scale, splits
        assert float((nll - ref_nll).abs().max()) <= 1e-4 * scale, splits


@pytest.mark.cuda
def test_fused_xent_f32_takes_the_first_design(cuda):
    from opendiloco_torch.ops import fused_xent as tfx

    N, D, V = 300, 256, 1000
    h, w, labels, gup = _xent_inputs(cuda, N, D, V, torch.float32)
    _, lse = tfx.fused_xent_fwd_plain(h, w, labels)
    n0 = dict(tdk.LAUNCHES)
    tfx.fused_xent_fwd(h, w, labels)
    dlog = tfx.fused_xent_dlog(h, w, labels, lse, gup)
    tfx.fused_xent_dh(dlog, w)
    torch.cuda.synchronize()
    for name in ("fused_xent_fwd", "fused_xent_dlog", "fused_xent_dh"):
        assert tdk.LAUNCHES[name] == n0[name] + 1
    for name in tfx.SM90_NAMES:
        assert tdk.LAUNCHES[name] == n0[name]
    assert tfx._route(torch.float32) == tfx.SOURCE
    assert tfx._route(torch.bfloat16) == tfx.SM90_SOURCE


def test_fused_xent_route_rule():
    # decided from dtype and sizes alone, so it holds without a card
    from opendiloco_torch.ops import fused_xent as tfx

    assert tfx._route(torch.bfloat16) == tfx.SM90_SOURCE
    assert tfx._route(torch.float32) == tfx.SOURCE
    assert tfx._route(torch.bfloat16, tfx.SOURCE) == tfx.SOURCE
    for dtype, route in ((torch.float32, tfx.SM90_SOURCE), (torch.bfloat16, "fused_xent_sm80")):
        with pytest.raises(ValueError):
            tfx._route(dtype, route)


@pytest.mark.cuda
@pytest.mark.parametrize("bad", [dict(dtype=torch.float32), dict(route="fused_xent_sm80"), dict(D=12)])
def test_fused_xent_sm90_route_refuses(cuda, bad):
    """The sm90 route forced on what it does not take raises, and nothing
    launches."""
    from opendiloco_torch.ops import fused_xent as tfx

    N, D, V = 64, bad.get("D", 64), 128
    dtype = bad.get("dtype", torch.bfloat16)
    route = bad.get("route", tfx.SM90_SOURCE)
    h = torch.zeros(N, D, device=cuda, dtype=dtype)
    w = torch.zeros(D, V, device=cuda, dtype=dtype)
    labels = torch.zeros(N, dtype=torch.int64, device=cuda)
    stats = torch.zeros(N, device=cuda)
    dlog = torch.zeros(N, V, device=cuda, dtype=dtype)
    n0 = dict(tdk.LAUNCHES)
    with pytest.raises(ValueError):
        tfx.fused_xent_fwd(h, w, labels, route=route)
    with pytest.raises(ValueError):
        tfx.fused_xent_dlog(h, w, labels, stats, stats, route=route)
    with pytest.raises(ValueError):
        tfx.fused_xent_dh(dlog, w, route=route)
    with pytest.raises(ValueError):
        tfx.fused_xent_dw(h, dlog, route=route)
    assert tdk.LAUNCHES == n0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_xent_autograd_matches_the_materialized_loss(cuda, dtype):
    """The autograd function over three backward chunks against autograd
    through the plain materialized loss (f32 logits, log-softmax, gather),
    element by element: f32 within rtol 1e-5 plus 1e-6 of each gradient's
    largest value; bf16 inputs within rtol 2**-6 plus 2**-9 of the largest
    value, since the kernels round dlog to bf16 before both products (its
    rounding errors, summed over the rows, reach 6e-4 of the largest dw
    where an element nearly cancels: the plain versions on the CPU) and
    write dh and dw in bf16."""
    from opendiloco_torch.ops import fused_xent as tfx

    h, w, labels, _ = _xent_inputs(cuda, 4500, 256, 1000, dtype)
    grads = []
    for fused in (True, False):
        hh, ww = h.clone().requires_grad_(True), w.clone().requires_grad_(True)
        if fused:
            loss = tfx.fused_linear_cross_entropy(hh, ww, labels)
        else:
            loss = torch.nn.functional.cross_entropy(hh.float() @ ww.float(), labels, ignore_index=-100)
        grads.append([loss.detach(), *torch.autograd.grad(loss, (hh, ww))])
    (fl, fdh, fdw), (pl, pdh, pdw) = grads
    assert fdh.dtype == fdw.dtype == dtype
    assert abs(float(fl) - float(pl)) <= 1e-5 * float(pl)
    rtol, atol = (1e-5, 1e-6) if dtype == torch.float32 else (2.0**-6, 2.0**-9)
    for got, ref in ((fdh, pdh), (fdw, pdw)):
        assert _share_of_limit(got, ref, rtol, atol * float(ref.float().abs().max())) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize(
    "bad",
    [
        dict(dtype=torch.float64),  # no kernel instance (f32, bf16 and f16 have one)
        dict(D=12),  # not a multiple of 8
        dict(V=100),  # not a multiple of 8
        dict(strided=True),  # a transposed (tied) head: not contiguous
        dict(cpu_labels=True),  # tensors on two devices
        dict(int32_labels=True),
    ],
)
def test_fused_xent_rejects(cuda, bad):
    from opendiloco_torch.ops import fused_xent as tfx

    N, D, V = 64, bad.get("D", 64), bad.get("V", 128)
    dtype = bad.get("dtype", torch.bfloat16)
    h = torch.zeros(N, D, device=cuda, dtype=dtype)
    w = torch.zeros(V, D, device=cuda, dtype=dtype).T if bad.get("strided") else torch.zeros(
        D, V, device=cuda, dtype=dtype)
    labels = torch.zeros(N, dtype=torch.int32 if bad.get("int32_labels") else torch.int64,
                         device="cpu" if bad.get("cpu_labels") else cuda)
    stats = torch.zeros(N, device=cuda)
    dlog = torch.zeros(V, N, device=cuda, dtype=dtype).T if bad.get("strided") else torch.zeros(
        N, V, device=cuda, dtype=dtype)
    n0 = dict(tdk.LAUNCHES)
    with pytest.raises(ValueError):
        tfx.fused_xent_fwd(h, w, labels)
    with pytest.raises(ValueError):
        tfx.fused_xent_dlog(h, w, labels, stats, stats)
    if not (bad.get("cpu_labels") or bad.get("int32_labels")):
        with pytest.raises(ValueError):
            tfx.fused_xent_dh(dlog, w)
        with pytest.raises(ValueError):
            tfx.fused_xent_dw(h, dlog)
    assert tdk.LAUNCHES == n0


# ---------------------------------------------------------------------------
# B7: speculative tail attention
# ---------------------------------------------------------------------------

# (S, T, Kh, rep, D, Kq, Kt, q_start, lens): the config_1b verify, draft and
# suffix shapes, and small odd ones. lens takes in an empty slot, a tile
# edge, the last rows, exactly T and a wrapped ring (2T + 1)
SPEC_GEOMS = [
    (8, 1024, 4, 8, 64, 5, 5, 0, [0, 5, 64, 700, 1022, 1024, 2049, 1500]),  # verify
    *((8, 1024, 4, 8, 64, 1, 4, i, [0, 5, 64, 700, 1022, 1024, 2049, 1500]) for i in range(4)),  # draft
    (1, 1024, 4, 8, 64, 256, 256, 0, [192]),  # suffix behind a 192-row prefix
    (1, 1024, 4, 8, 64, 1000, 1000, 0, [192]),  # an odd suffix bucket
    (3, 40, 1, 1, 8, 3, 6, 2, [39, 1, 85]),  # D 8, rep 1, a ragged ring tile
    (2, 96, 2, 3, 128, 7, 7, 0, [95, 200]),  # D 128, odd rep
    (2, 70, 4, 2, 40, 65, 65, 0, [0, 69]),  # D 40, a tail of two tiles
]


def _spec_inputs(dev, S, T, Kh, rep, D, Kq, Kt, dtype, lens, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed + S * T + D + Kq)
    q = torch.randn(S, Kq, Kh * rep, D, generator=g, device=dev).to(dtype)
    ck = torch.randn(S, T, Kh, D, generator=g, device=dev).to(dtype)
    cv = torch.randn(S, T, Kh, D, generator=g, device=dev).to(dtype)
    tk = torch.randn(S, Kt, Kh, D, generator=g, device=dev).to(dtype)
    tv = torch.randn(S, Kt, Kh, D, generator=g, device=dev).to(dtype)
    return q, ck, cv, tk, tv, torch.tensor(lens, dtype=torch.int32, device=dev)


def _spec_tol(ref, dtype):
    """Per (slot, query token): f32 1e-5 of the largest output (at least
    1e-5), only the order of f32 sums differs; bf16 2**-6 of the largest
    output, as B6: p rounds to bf16 at each tile's running max in the
    kernel and at the global max in the plain version, and both outputs
    round to bf16."""
    top = ref.float().abs().amax(dim=(2, 3))
    return 1e-5 * top.clamp(min=1.0) if dtype == torch.float32 else ATTN_SHARE[dtype] * top


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("geom", SPEC_GEOMS, ids=lambda g: "x".join(map(str, g[:8])))
def test_spec_tail_attention_matches_plain(cuda, geom, dtype):
    S, T, Kh, rep, D, Kq, Kt, q_start, lens = geom
    args = _spec_inputs(cuda, S, T, Kh, rep, D, Kq, Kt, dtype, lens)
    n0 = tdk.LAUNCHES["spec_tail_attention"]
    out = tdk.spec_tail_attention_fused(*args, q_start=q_start)
    torch.cuda.synchronize()
    assert tdk.LAUNCHES["spec_tail_attention"] == n0 + 1
    assert out.dtype == dtype and out.shape == args[0].shape
    ref = tdk.spec_tail_attention_plain(*args, q_start=q_start)
    err = (out.float() - ref.float()).abs().amax(dim=(2, 3))
    tol = _spec_tol(ref, dtype)
    print(f"B7 {geom[:8]} {dtype}: max err/tol {float((err / tol).max()):.3f}")
    assert bool((err <= tol).all()), f"per (slot, token) error {err.tolist()} over {tol.tolist()}"


# (S, T, Kh, rep, D, Kq, Kt, q_start, lens, splits): the config_1b ring at
# the verify and draft shapes with whole splits empty (lens 0) or past the
# live length, lens >= T at q_start 3 (the first rows evicted), lens T - 2
# with a split boundary inside the live ring, splits that leave a split
# all dead (T 32 in 8 splits of 4 rows: lens T at q_start 3 evicts split 0),
# and the suffix pass of a prefix hit padded to the 64 bucket (8 query tiles,
# the wrapper's 8 splits of 128 rows, the prefix live in split 0 and half
# of split 1)
SPLIT_GEOMS = [
    *((8, 1024, 4, 8, 64, 5, 5, 0, [0, 0, 5, 127, 128, 129, 1022, 1024], sp) for sp in (None, 1, 2, 3, 8)),
    *((8, 1024, 4, 8, 64, 1, 4, 3, [0, 1024, 1027, 1022, 2049, 700, 256, 129], sp) for sp in (None, 1, 8)),
    (4, 1024, 4, 8, 64, 1, 4, 3, [1024, 1024, 1025, 2 * 1024 + 1], 8),
    (3, 32, 2, 4, 64, 2, 5, 3, [32, 0, 30], 8),
    (1, 1024, 4, 8, 64, 256, 256, 0, [192], 2),
    (1, 1024, 4, 8, 64, 64, 64, 0, [192], None),
    (2, 96, 2, 3, 40, 7, 7, 0, [95, 200], 3),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("geom", SPLIT_GEOMS, ids=lambda g: "x".join(map(str, g[:8])) + f"-s{g[9]}")
def test_spec_tail_attention_splits_match_plain_and_repeat(cuda, geom, dtype):
    """The split kernel and its merge against the one-pass plain version
    (the tolerances of test_spec_tail_attention_matches_plain) and the
    split plain version, with no NaN and the same bits on a second
    launch; the merge runs exactly when there is more than one split."""
    S, T, Kh, rep, D, Kq, Kt, q_start, lens, splits = geom
    args = _spec_inputs(cuda, S, T, Kh, rep, D, Kq, Kt, dtype, lens)
    n0 = dict(tdk.LAUNCHES)
    out = tdk.spec_tail_attention_fused(*args, q_start=q_start, splits=splits)
    again = tdk.spec_tail_attention_fused(*args, q_start=q_start, splits=splits)
    torch.cuda.synchronize()
    used = splits or tdk.spec_tail_splits(S, T, Kh, Kq * rep, tdk._sm_count(cuda.index or 0))
    used = tdk.spec_tail_split_chunk(T, used)[0]
    assert tdk.LAUNCHES["spec_tail_attention"] == n0["spec_tail_attention"] + 2
    merges = tdk.LAUNCHES["spec_tail_attention_merge"] - n0["spec_tail_attention_merge"]
    assert merges == (2 if used > 1 else 0)
    assert bool(torch.isfinite(out.float()).all()) and torch.equal(out, again)
    tol = _spec_tol(tdk.spec_tail_attention_plain(*args, q_start=q_start), dtype)
    for ref in (tdk.spec_tail_attention_plain(*args, q_start=q_start),
                tdk.spec_tail_attention_split_plain(*args, q_start=q_start, splits=used)):
        err = (out.float() - ref.float()).abs().amax(dim=(2, 3))
        assert bool((err <= tol).all()), f"per (slot, token) error {err.tolist()} over {tol.tolist()}"
    print(f"B7 split {geom[:8]} splits {used} {dtype}: max err/tol {float((err / tol).max()):.3f}")


def test_spec_tail_split_rule():
    # from the static shape alone (lens stays on the device), without a card:
    # config_1b's draft (Kq rep 8) and verify (40) shapes fill 132 SMs with 8
    # splits of 128 ring rows, as does the suffix pass padded to the 64
    # bucket (8 query tiles); the 256 and 1024 buckets' query tiles fill it
    # alone
    assert tdk.spec_tail_splits(8, 1024, 4, 8, 132) == 8
    assert tdk.spec_tail_splits(8, 1024, 4, 40, 132) == 8
    assert tdk.spec_tail_splits(1, 1024, 4, 64 * 8, 132) == 8
    assert tdk.spec_tail_splits(1, 1024, 4, 256 * 8, 132) == 1
    assert tdk.spec_tail_splits(1, 1024, 4, 1000 * 8, 132) == 1
    assert tdk.spec_tail_splits(8, 64, 4, 8, 132) == 1  # a ring of one split's rows
    assert tdk.spec_tail_split_chunk(1024, 8) == (8, 128)
    assert tdk.spec_tail_split_chunk(10, 8) == (5, 2)  # no split left empty
    assert tdk.spec_tail_split_chunk(5, 9) == (5, 1)
    assert [tdk.spec_tail_rows_per_block(r) for r in (8, 16, 17, 32, 40)] == [16, 16, 32, 32, 64]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_spec_tail_attention_loads_nothing_of_an_evicted_split(cuda, dtype):
    """A split whose rows are all evicted loads nothing: with lens = T at
    q_start 3, the ring writes of tail tokens 0 .. 3 replaced rows 0 .. 3
    for every query, split 0 of 8 (4 rows each). Those rows hold NaN: a
    kernel that loaded them would return NaN, since 0 * NaN is NaN."""
    S, T, Kh, rep, D, Kq, Kt, q_start = 2, 32, 2, 4, 64, 2, 5, 3
    q, ck, cv, tk, tv, lens = _spec_inputs(cuda, S, T, Kh, rep, D, Kq, Kt, dtype, [T, 30])
    clean = tuple(t.clone() for t in (ck, cv))
    for t in (ck, cv):
        t[0, :4] = float("nan")
    out = tdk.spec_tail_attention_fused(q, ck, cv, tk, tv, lens, q_start=q_start, splits=8)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out.float()).all())
    ref = tdk.spec_tail_attention_plain(q, *clean, tk, tv, lens, q_start=q_start)
    assert bool(((out.float() - ref.float()).abs().amax(dim=(2, 3)) <= _spec_tol(ref, dtype)).all())


# (S, Kq, Kt, lens): config_1b's verify shape and a prefix hit's suffix
# pass in the 64 bucket, both at the wrapper's 8 splits of 128 rows
MERGE_GEOMS = [
    (8, 5, 5, [0, 5, 127, 128, 700, 1022, 1024, 2049]),
    (1, 64, 64, [192]),
]


@pytest.mark.cuda
@pytest.mark.parametrize("geom", MERGE_GEOMS, ids=lambda g: f"S{g[0]}xKq{g[1]}")
def test_spec_tail_merge_matches_its_plain_version(cuda, geom):
    """The merge kernel on the split kernel's own partials against the
    plain merge of the same partials: the same f32 sums in the same
    order, exp on both sides correctly rounded to within an ulp or two."""
    S, Kq, Kt, lens = geom
    T, Kh, rep, D = 1024, 4, 8, 64
    args = _spec_inputs(cuda, S, T, Kh, rep, D, Kq, Kt, torch.float32, lens)
    ml, acc = tdk._spec_tail_partials(*args, q_start=0, splits=8, chunk=128)
    out = tdk.spec_tail_merge(ml, acc, Kq, torch.float32)
    ref = tdk.spec_tail_merge_plain(ml, acc, Kq, torch.float32)
    torch.cuda.synchronize()
    assert bool((ml[..., 1][ml[..., 0] == float("-inf")] == 0).all())  # a dead split: m -inf, l 0
    torch.testing.assert_close(out, ref, atol=1e-6, rtol=1e-6)


@pytest.mark.cuda
def test_spec_tail_attention_repeats_bitwise_and_reads_no_dead_rows(cuda):
    S, T, Kh, rep, D, K = 2, 256, 2, 4, 64, 5
    q, ck, cv, tk, tv, lens = _spec_inputs(cuda, S, T, Kh, rep, D, K, K, torch.bfloat16, [70, 130])
    clean = tuple(t.clone() for t in (ck, cv))
    # ring rows past the live length hold NaN: a kernel that read them
    # would return NaN, since 0 * NaN is NaN
    for t in (ck, cv):
        t[0, 70:] = float("nan")
        t[1, 130:] = float("nan")
    a = tdk.spec_tail_attention_fused(q, ck, cv, tk, tv, lens)
    b = tdk.spec_tail_attention_fused(q, ck, cv, tk, tv, lens)
    torch.cuda.synchronize()
    assert torch.isfinite(a.float()).all()
    assert torch.equal(a, b)  # no atomics: the same bits every launch
    ref = tdk.spec_tail_attention_plain(q, *clean, tk, tv, lens)
    assert bool(((a.float() - ref.float()).abs().amax(dim=(2, 3)) <= _spec_tol(ref, torch.bfloat16)).all())


@pytest.mark.cuda
@pytest.mark.parametrize(
    "bad",
    [
        dict(D=12),  # not a multiple of 8
        dict(D=136),  # above 128
        dict(H=6),  # 6 query heads over 4 kv heads
        dict(dtype=torch.float64),  # no kernel instance (f32, bf16 and f16 have one)
        dict(strided=True),  # a non-contiguous tail
        dict(lens_dtype=torch.int64),
        dict(cpu_lens=True),  # tensors on two devices
        dict(q_start=-1),
    ],
)
def test_spec_tail_attention_rejects(cuda, bad):
    D, H, dtype = bad.get("D", 64), bad.get("H", 8), bad.get("dtype", torch.float32)
    q = torch.zeros(2, 3, H, D, device=cuda, dtype=dtype)
    ck = torch.zeros(2, 16, 4, D, device=cuda, dtype=dtype)
    tk = torch.zeros(2, 3, 4, D, device=cuda, dtype=dtype)
    if bad.get("strided"):
        tk = torch.zeros(3, 2, 4, D, device=cuda, dtype=dtype).transpose(0, 1)
    lens = torch.zeros(2, dtype=bad.get("lens_dtype", torch.int32),
                       device="cpu" if bad.get("cpu_lens") else cuda)
    n0 = tdk.LAUNCHES["spec_tail_attention"]
    with pytest.raises(ValueError):
        tdk.spec_tail_attention_fused(q, ck, ck, tk, tk, lens, q_start=bad.get("q_start", 0))
    assert tdk.LAUNCHES["spec_tail_attention"] == n0


@pytest.mark.cuda
@pytest.mark.parametrize("weight_format", ["fp32", "w4"])
def test_engine_weight_copies_are_ordered_for_the_caller(cuda, weight_format):
    """A serving engine copies weights in on its own stream: after the work
    queued on the caller's stream (here a 0.3 s sleep, then the doubling of
    the weights in place), and done when ``install_params`` returns, so
    the caller reads ``engine.params`` and writes its own tensors again
    on its stream with no sync."""
    from opendiloco_torch.models.llama import LlamaConfig, PackedW4, flatten_params, init_params
    from opendiloco_torch.serve.engine import ServeEngine

    cfg = LlamaConfig(vocab_size=256, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
                      num_attention_heads=4)
    params = init_params(torch.Generator(device=cuda).manual_seed(0), cfg)
    engine = ServeEngine(cfg, params, num_slots=2, max_context=64, prefill_buckets=(16,),
                         compute_dtype=torch.float32, weight_format=weight_format, device=cuda)
    leaves = flatten_params(params)
    want = [quant.pack_blockwise4_stacked(2 * x) if isinstance(w, PackedW4) else 2 * x
            for x, w in zip(leaves, flatten_params(engine.params))]
    torch.cuda.synchronize()
    torch.cuda._sleep(2**29)
    for x in leaves:
        x.mul_(2)
    engine.install_params(1, params)
    for x in leaves:
        x.zero_()
    got = [(w.q, w.s) if isinstance(w, PackedW4) else w for w in flatten_params(engine.params)]
    same = [all(map(torch.equal, g, w)) if isinstance(g, tuple) else torch.equal(g, w) for g, w in zip(got, want)]
    assert all(same), same


@pytest.mark.cuda
def test_outer_plane_snapshots_wait_for_queued_writes(cuda):
    """The device outer plane's host snapshots, taken from other threads
    (each on a stream of its own, as the serving engine's batcher is)
    while the plane's writes are still queued on the trainer's stream
    behind a 0.3 s sleep, see the written values: the post-round masters
    and momentum of the eager estimate, bit for bit the host OuterSGD's,
    and their f16 casts for the serving snapshot."""
    import threading

    import numpy as np

    from opendiloco_torch.diloco.outer_device import DeviceOuterPlane
    from opendiloco_torch.diloco.outer_optimizer import OuterSGD

    gen = torch.Generator(device=cuda).manual_seed(0)
    leaves = [torch.randn(s, generator=gen, device=cuda) for s in ((4096, 1024), (1024,), (2048, 2048))]
    plane = DeviceOuterPlane(leaves, lr=0.7, momentum=0.9, nesterov=True)
    params = [x - 1e-3 * torch.randn(x.shape, generator=gen, device=cuda) for x in leaves]
    pre, bufs = plane.host_state()
    assert bufs is None
    host_params = [p.cpu().numpy() for p in params]
    est = [m.copy() for m in pre]
    opt = OuterSGD(0.7, 0.9, nesterov=True)
    opt.step(est, [m - p for m, p in zip(pre, host_params)])
    pg = [m - p for m, p in zip(plane.masters, params)]
    boundary = plane.copy_leaves(params)
    torch.cuda.synchronize()
    torch.cuda._sleep(2**29)
    plane.estimate(pg, boundary)  # returns at once; its writes wait behind the sleep
    got: dict = {}

    def snap(key, fn):
        with torch.cuda.stream(torch.cuda.Stream()):
            got[key] = fn()

    threads = [threading.Thread(target=snap, args=("state", plane.host_state)),
               threading.Thread(target=snap, args=("f16", lambda: plane.host_masters(wire_dtype="float16")))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    masters, bufs = got["state"]
    assert all(np.array_equal(a, b) for a, b in zip(masters, est))
    assert all(np.array_equal(a, b) for a, b in zip(bufs, opt.bufs))
    assert all(np.array_equal(a, b.astype(np.float16)) for a, b in zip(got["f16"], est))


@pytest.mark.cuda
def test_engine_tier_pages_are_by_value_and_ordered(cuda):
    """The KV tier's page transfers on the card: a fetch queued behind a
    0.3 s sleep on the engine's stream copies a slot's rows as they were
    when it was called, although the slot's next tenant is written right
    after it; an install returns at once and takes arrays the caller
    overwrites afterwards; bf16 -> f32 -> bf16 is exact."""
    import numpy as np

    from opendiloco_torch.models.llama import LlamaConfig, init_params
    from opendiloco_torch.serve.engine import ServeEngine

    cfg = LlamaConfig(vocab_size=256, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
                      num_attention_heads=4)
    params = init_params(torch.Generator(device=cuda).manual_seed(0), cfg)
    engine = ServeEngine(cfg, params, num_slots=3, max_context=64, prefill_buckets=(16, 32), device=cuda)
    assert engine.cache_k.dtype == torch.bfloat16
    engine.admit(0, list(range(1, 15)))
    want = [c[:, 0, :16].float().cpu() for c in (engine.cache_k, engine.cache_v)]
    with torch.cuda.stream(engine.stream):
        torch.cuda._sleep(2**29)
    pk, pv = engine.fetch_slot_pages(0, 14)
    engine.admit(0, list(range(100, 130)))  # the next tenant, queued after the gather
    k, v = np.asarray(pk), np.asarray(pv)
    assert k.dtype == np.float32 and k.shape == (2, 16, cfg.kv_heads, cfg.head_dim)
    assert np.array_equal(k, want[0].numpy()) and np.array_equal(v, want[1].numpy())
    assert not torch.equal(engine.cache_k[:, 0, :16].float().cpu(), want[0])
    with torch.cuda.stream(engine.stream):
        torch.cuda._sleep(2**29)
    k2, v2 = k.copy(), v.copy()
    engine.install_slot_pages(2, k2, v2)
    k2[...] = 0
    v2[...] = 0
    engine.stream.synchronize()
    assert torch.equal(engine.cache_k[:, 2, :16].float().cpu(), want[0])
    assert torch.equal(engine.cache_v[:, 2, :16].float().cpu(), want[1])


# ---------------------------------------------------------------------------
# f16 (precision="fp16-mixed"): the sm90 instances and the dispatch
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("grad_f32", [False, True], ids=["f16-grads", "f32-grads"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("geom", SM90_GEOMS, ids=lambda g: "x".join(map(str, g)))
def test_flash_attention_sm90_f16_matches_plain(cuda, geom, causal, grad_f32):
    """The f16 instances of the sm90 forward and backward (D 32, 64, 128)
    against the plain versions at test_flash_attention_sm90_backward's
    geometries, the gradients in f16 or (``grad_dtype``, the ring's) f32,
    each head within 2**-9 of its largest output."""
    from opendiloco_torch.ops import flash_attention as tfa

    B, T, H, Hkv, D = geom
    q, k, v, do = _flash_inputs(cuda, *geom, torch.float16, seed=5)
    out, lse = tfa.flash_attention_fwd_plain(q, k, v, causal)
    delta = tfa.attention_delta(do, out)
    gd = torch.float32 if grad_f32 else None
    n0 = dict(tdk.LAUNCHES)
    got_out, got_lse = tfa.flash_attention_fwd(q, k, v, causal)
    dq = tfa.flash_attention_dq(q, k, v, do, lse, delta, causal, grad_dtype=gd)
    dk, dv = tfa.flash_attention_dkv(q, k, v, do, lse, delta, causal, grad_dtype=gd)
    torch.cuda.synchronize()
    for name in ("flash_attention_fwd_sm90", "flash_attention_dq_sm90", "flash_attention_dkv_sm90"):
        assert tdk.LAUNCHES[name] == n0[name] + 1
    for name in ("flash_attention_fwd", "flash_attention_dq", "flash_attention_dkv"):
        assert tdk.LAUNCHES[name] == n0[name]
    assert float((got_lse - lse).abs().max()) <= 1e-4 * max(1.0, float(lse.abs().max()))
    ref_dq = tfa.flash_attention_dq_plain(q, k, v, do, lse, delta, causal, grad_dtype=gd)
    ref_dk, ref_dv = tfa.flash_attention_dkv_plain(q, k, v, do, lse, delta, causal, grad_dtype=gd)
    for name, got, ref in (("out", got_out, out), ("dq", dq, ref_dq), ("dk", dk, ref_dk), ("dv", dv, ref_dv)):
        assert got.dtype == (torch.float16 if name == "out" or not grad_f32 else torch.float32)
        err, tol = _flash_err(got, ref), _flash_tol(ref, torch.float16)
        print(f"f16 {name} {geom} causal={causal}: max err/tol {float((err / tol).max()):.3f}")
        assert bool((err <= tol).all()), f"{name}: per-head error {err.tolist()} over {tol.tolist()}"


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SM90_W4_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("M", [1, 8, 40, 1024])
def test_w4_matmul_sm90_f16_matches_plain_and_repeats(cuda, shape, M):
    """The f16 instance of the sm90 B8: the weight rounded once to f16,
    f32 sums, the output rounded once to f16, so 2**-10 of the largest
    output (bf16's 2**-7 over 8); bit for bit on a second launch."""
    K, N = shape
    q, s, g = _packed(cuda, K, N, seed=K + N + M + 1)
    x = torch.randn(M, K, generator=g, device=cuda).to(torch.float16)
    n0 = dict(tdk.LAUNCHES)
    out = tdk.w4_matmul(x, q, s, shape, torch.float16)
    torch.cuda.synchronize()
    assert tdk.LAUNCHES["w4_matmul_sm90"] == n0["w4_matmul_sm90"] + 1
    assert tdk.LAUNCHES["w4_matmul"] == n0["w4_matmul"]
    assert out.dtype == torch.float16 and out.shape == (M, N)
    assert torch.equal(out, tdk.w4_matmul(x, q, s, shape, torch.float16))
    ref = tdk.w4_matmul_plain(x, q, s, shape, torch.float16).float()
    assert float((out.float() - ref).abs().max()) <= 2**-7 * F16 * float(ref.abs().max())
    first = tdk.w4_matmul(x, q, s, shape, torch.float16, route=tdk.W4_FIRST_SOURCE)
    assert float((first.float() - ref).abs().max()) <= 2**-7 * F16 * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("geom", SM90_XENT_GEOMS, ids=lambda g: "x".join(map(str, g)))
def test_fused_xent_sm90_f16_matches_plain_and_repeats(cuda, geom):
    """The f16 instances of the sm90 B3, dlog, dh and dw against their
    plain versions and the first design's f16 instances (through route=),
    with test_fused_xent_kernels_match_plain's f16 limits and the upstream
    gradient times 2**15; each repeats bit for bit."""
    from opendiloco_torch.ops import fused_xent as tfx

    N, D, V = geom
    h, w, labels, gup = _xent_inputs(cuda, N, D, V, torch.float16)
    gup = gup * 2.0**15
    n0 = dict(tdk.LAUNCHES)
    runs = []
    for route in (None, None, tfx.SOURCE):
        nll, lse = tfx.fused_xent_fwd(h, w, labels, route=route)
        dlog = tfx.fused_xent_dlog(h, w, labels, lse, gup, route=route)
        runs.append((nll, lse, dlog, tfx.fused_xent_dh(dlog, w, route=route), tfx.fused_xent_dw(h, dlog, route=route)))
    torch.cuda.synchronize()
    for name in tfx.SM90_NAMES:
        assert tdk.LAUNCHES[name] == n0[name] + 2
    for name in tfx.NAMES:
        assert tdk.LAUNCHES[name] == n0[name] + 1
    assert all(torch.equal(a, b) for a, b in zip(runs[0], runs[1]))
    ref_nll, ref_lse = tfx.fused_xent_fwd_plain(h, w, labels)
    scale = max(1.0, float(ref_lse.abs().max()))
    r = 2.0**-7 * F16
    for nll, lse, dlog, dh, dw in (runs[0], runs[2]):
        assert dlog.dtype == dh.dtype == torch.float16 and dw.dtype == torch.float32
        assert float((lse - ref_lse).abs().max()) <= 1e-4 * scale
        assert float((nll - ref_nll).abs().max()) <= 1e-4 * scale
        ref_dlog = tfx.fused_xent_dlog_plain(h, w, labels, lse, gup)
        assert _share_of_limit(dlog, ref_dlog, r, r / 2 * float(gup.max()) / V) <= 1.0
        ref_dh = tfx.fused_xent_dh_plain(dlog, w)
        assert _share_of_limit(dh, ref_dh, r, 1e-5 * F16 * float(ref_dh.float().abs().max())) <= 1.0
        assert _rel_err(dw, tfx.fused_xent_dw_plain(h, dlog)) <= 1e-5


@pytest.mark.cuda
def test_f16_tensors_reach_the_f16_instances(cuda):
    """An f16 CUDA tensor reaches the kernel's ``*_f16`` symbol on every
    route (and never a plain version: each call is counted as a launch); a
    dtype no kernel has raises before any launch."""
    from opendiloco_torch.ops import flash_attention as tfa
    from opendiloco_torch.ops import fused_xent as tfx
    from opendiloco_torch.ops import launch

    q, k, v, do = _flash_inputs(cuda, 1, 128, 4, 2, 64, torch.float16)
    for D in (64, 40):  # the sm90 route, then the first design
        qq, kk, vv, dd = (t[..., :D].contiguous() for t in (q, k, v, do))
        out, lse = tfa.flash_attention_fwd(qq, kk, vv)
        delta = tfa.attention_delta(dd, out)
        tfa.flash_attention_dq(qq, kk, vv, dd, lse, delta)
        tfa.flash_attention_dkv(qq, kk, vv, dd, lse, delta)
    h, w, labels, gup = _xent_inputs(cuda, 256, 128, 512, torch.float16)
    for route in (None, tfx.SOURCE):
        _, lse = tfx.fused_xent_fwd(h, w, labels, route=route)
        dlog = tfx.fused_xent_dlog(h, w, labels, lse, gup, route=route)
        tfx.fused_xent_dh(dlog, w, route=route)
        tfx.fused_xent_dw(h, dlog, route=route)
    qd, kd, vd, ln = _attn_inputs(cuda, 2, 96, 2, 3, 64, torch.float16, [95, 5])
    tdk.paged_decode_attention(qd, kd, vd, ln, splits=3)
    qd, kd, vd, ln = _attn_inputs(cuda, 2, 96, 2, 3, 256, torch.float16, [95, 5])
    tdk.paged_decode_attention(qd, kd, vd, ln)
    tdk.spec_tail_attention_fused(*_spec_inputs(cuda, 2, 96, 2, 3, 64, 3, 3, torch.float16, [95, 5]), splits=2)
    wq, ws, g = _packed(cuda, 64, 128, seed=1)
    x = torch.randn(8, 64, generator=g, device=cuda).half()
    tdk.w4_matmul(x, wq, ws, (64, 128), torch.float16)
    tdk.w4_matmul(x, wq, ws, (64, 128), torch.float16, route=tdk.W4_FIRST_SOURCE)
    torch.cuda.synchronize()
    for symbol in ("flash_attention_fwd_sm90_f16", "flash_attention_dq_sm90_f16", "flash_attention_dkv_sm90_f16",
                   "flash_attention_fwd_f16", "flash_attention_dq_f16", "flash_attention_dkv_f16",
                   "flash_attention_delta_f16", *(f"{n}_f16" for n in tfx.NAMES + tfx.SM90_NAMES),
                   "paged_decode_split_f16", "paged_decode_attention_f16", "spec_tail_attention_f16",
                   "spec_tail_attention_merge_f16", "w4_matmul_sm90_f16", "w4_matmul_f16"):
        assert symbol in launch._fns, symbol
    n0 = dict(tdk.LAUNCHES)
    with pytest.raises(ValueError):
        tfa.flash_attention_fwd(q.double(), k.double(), v.double())
    assert tdk.LAUNCHES == n0
