"""Parity of the PyTorch port's serving ops with the JAX package.

The same numpy inputs, drawn from a seed, go through the JAX function
(Pallas kernels in interpret mode, as tests/test_decode_kernels.py runs
them) and through the port on the CPU, where each kernel wrapper takes its
plain version. Compared in f32:

- paged decode attention against the JAX kernel and ``decode_attention``
  over GQA ratios and ragged ``lens`` (atol 1e-5: the kernel's online
  softmax and the one-pass plain version sum in different orders);
- the W4 dequant-matmul against the JAX kernel (atol 1e-5 relative to the
  output's largest magnitude: K-long f32 sums reassociate); the identity
  probe and the blockwise-4-bit packer bit for bit;
- prefill and decode logits of the whole serving forward on tiny_cfg
  (GQA 4/2) and config_2m (atol 1e-4: sums reassociate across layers);
- weight conversion round trips bit for bit.

The CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_cuda_kernels.py and chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opendiloco_tpu.diloco.compression import pack_blockwise4_stacked as jax_pack
from opendiloco_tpu.models import llama as jllama
from opendiloco_tpu.ops import attention as jattn
from opendiloco_tpu.ops import decode_kernels as jdk
from opendiloco_torch import quant
from opendiloco_torch.models import llama as tllama
from opendiloco_torch.models.convert import params_from_numpy, params_to_numpy
from opendiloco_torch.models.hf_io import get_model, load_config
from opendiloco_torch.ops import attention as tattn
from opendiloco_torch.ops import decode_kernels as tdk

torch.set_num_threads(2)


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rep", [1, 2, 4])
def test_paged_decode_attention_plain_matches_jax(rep):
    Kh, S, T, D = 2, 5, 32, 16
    H = Kh * rep
    rng = np.random.default_rng(rep)
    q, k, v = _randn(rng, S, H, D), _randn(rng, S, T, Kh, D), _randn(rng, S, T, Kh, D)
    # empty slot, mid-block, last row, exactly T, wrapped past T
    lens = np.asarray([0, 5, T - 1, T, 2 * T + 3], np.int32)
    jq, jk, jv, jl = map(jnp.asarray, (q, k, v, lens))
    ref_kernel = np.asarray(jdk.paged_decode_attention(jq, jk, jv, jl, block_t=8, interpret=True))
    ref_plain = np.asarray(jattn.decode_attention(jq, jk, jv, jl))
    before = dict(tdk.LAUNCHES)
    out = tdk.paged_decode_attention(_t(q), _t(k), _t(v), _t(lens)).numpy()
    assert tdk.LAUNCHES == before  # the CPU takes the plain version: no launch
    np.testing.assert_allclose(out, ref_kernel, atol=1e-5)
    np.testing.assert_allclose(out, ref_plain, atol=1e-5)
    port_plain = tattn.decode_attention(_t(q), _t(k), _t(v), _t(lens)).numpy()
    np.testing.assert_allclose(port_plain, ref_plain, atol=1e-5)


@pytest.mark.parametrize("heads", [(4, 4), (4, 2)])
def test_xla_attention_matches_jax(heads):
    H, Kh = heads
    rng = np.random.default_rng(H + Kh)
    q, k, v = _randn(rng, 2, 12, H, 16), _randn(rng, 2, 12, Kh, 16), _randn(rng, 2, 12, Kh, 16)
    ref = np.asarray(jattn.xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    out = tattn.xla_attention(_t(q), _t(k), _t(v)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5)


# ---------------------------------------------------------------------------
# blockwise-4-bit packing and the W4 dequant-matmul
# ---------------------------------------------------------------------------


def _pack_both(w):
    jq, js = jax_pack(w)
    tq, ts = quant.pack_blockwise4_stacked(_t(w))
    return (jq, js), (tq, ts)


@pytest.mark.parametrize(
    "shape",
    [
        (2, 64, 64),  # one scale block per layer
        (3, 7, 9),  # odd per-layer length: last high nibble left 0
        (2, 64, 66),  # partial tail scale block
        (1, 2, 4097),  # odd length across a block edge
    ],
)
def test_packer_bitwise_matches_jax(shape):
    rng = np.random.default_rng(sum(shape))
    w = _randn(rng, *shape)
    # edge blocks: all zero (scale 1), above fp16 max, below fp16 min normal
    flat = w.reshape(shape[0], -1)
    flat[0, : min(4096, flat.shape[1]) // 2] = 0.0
    if shape[0] > 1:
        flat[1, :3] = [1e6, -7e5, 3.0]
    flat[-1] *= 1e-7
    (jq, js), (tq, ts) = _pack_both(w)
    np.testing.assert_array_equal(tq.numpy(), jq)
    np.testing.assert_array_equal(ts.numpy().view(np.uint16), js)


def test_packer_rounds_half_to_even():
    # amax 7 -> scale 7, so x * 7/7 = x: the .5 cases must round to even
    w = np.asarray([[7.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5]], np.float32)
    (jq, js), (tq, ts) = _pack_both(w)
    np.testing.assert_array_equal(tq.numpy(), jq)
    np.testing.assert_array_equal(ts.numpy().view(np.uint16), js)


@pytest.mark.parametrize("shape", [(64, 64), (64, 66), (32, 4128), (8, 8192)])
def test_w4_matmul_plain_matches_jax(shape):
    K, N = shape
    rng = np.random.default_rng(K + N)
    (jq, js), (tq, ts) = _pack_both(_randn(rng, 1, K, N))
    x = _randn(rng, 8, K)
    ref = np.asarray(
        jdk.w4_matmul(jnp.asarray(x), jnp.asarray(jq[0]), jnp.asarray(js[0]), (K, N),
                      jnp.float32, interpret=True)
    )
    out = tdk.w4_matmul(_t(x), tq[0], ts[0], (K, N), torch.float32).numpy()
    scale = float(np.abs(ref).max()) or 1.0
    np.testing.assert_allclose(out / scale, ref / scale, atol=1e-5)


@pytest.mark.parametrize("shape", [(64, 64), (64, 66), (32, 4128)])
def test_w4_identity_probe_is_bitwise_dequant(shape):
    K, N = shape
    rng = np.random.default_rng(K * N)
    (jq, js), (tq, ts) = _pack_both(_randn(rng, 1, K, N))
    ref = np.asarray(jllama.dequant_w4(jnp.asarray(jq[0]), jnp.asarray(js[0]), (K, N), jnp.float32))
    np.testing.assert_array_equal(quant.dequant_w4(tq[0], ts[0], (K, N), torch.float32).numpy(), ref)
    out = tdk.w4_matmul(torch.eye(K), tq[0], ts[0], (K, N), torch.float32).numpy()
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_w4_sm90_dequant_equals_dequant_w4_bitwise(monkeypatch, dtype):
    """The sm90 B8's dequant arithmetic (a factor a scale, 2^23 + nib less
    2^23 + 8, one multiply, one rounding), emulated in torch, against
    dequant_w4 for every finite fp16 scale pattern and all 16 nibbles.
    dequant_w4 runs with scale blocks of 16 elements (the block size only
    maps scales to elements), so each block holds the 16 nibbles once."""
    bits = torch.arange(-(2**15), 2**15, dtype=torch.int32).to(torch.int16)
    bits = bits[torch.isfinite(bits.view(torch.float16))]
    assert bits.numel() == 2**16 - 2 * 1024  # less the infinities and NaNs
    nib = torch.arange(16, dtype=torch.uint8)
    flat = nib.repeat(bits.numel())
    q = flat[0::2] | (flat[1::2] << 4)
    monkeypatch.setattr(quant, "W4_BLOCK", 16)
    ref = quant.dequant_w4(q, bits, (bits.numel(), 16), dtype)
    emu = tdk.w4_sm90_dequant_plain(nib[None, :], bits[:, None], dtype)
    assert emu.dtype == ref.dtype == dtype
    wide = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(emu.view(wide), ref.view(wide))


# the seven matmul weights of a config_1b layer (q, k, v, o, gate, up, down
# give four shapes), then shapes off the tile grid: K not a multiple of 16,
# one column tile, a K shorter than a split step, a deep down projection
W4_1B_SHAPES = [(2048, 2048), (2048, 256), (2048, 5632), (5632, 2048)]
W4_ODD_SHAPES = [(200, 64), (64, 128), (8, 64), (5632, 64), (1000, 2048), (24, 5632)]


@pytest.mark.parametrize("shape", W4_1B_SHAPES + W4_ODD_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_w4_split_rule(shape):
    """The sm90 B8's K splits: a function of (M, K, N, SMs) alone, between
    1 and the 16-row steps of K (so no split is empty) and at most
    W4_MAX_SPLITS; below that cap, enough blocks for twice the SMs. At
    decode on 132 SMs the config_1b shapes take 8, 8, 3 and 8 splits. (The
    kernel's own cover of K is checked on the card against the plain
    version, at forced split counts.)"""
    K, N = shape
    for M in (1, 8, 40, 100, 1024):
        for sms in (132, 114, 16, 1):
            splits = tdk.w4_splits(M, K, N, sms)
            assert splits == tdk.w4_splits(M, K, N, sms) and 1 <= splits <= min(-(-K // 16), tdk.W4_MAX_SPLITS)
            tiles = -(-M // (16 * tdk.w4_slices(M))) * (N // tdk.W4_TILE_N)
            if splits < min(-(-K // 16), tdk.W4_MAX_SPLITS):
                assert tiles * splits >= 2 * sms, (M, shape, sms, splits)
            if splits > 1:
                assert tiles * (splits - 1) < 2 * sms, (M, shape, sms, splits)
    if shape in W4_1B_SHAPES:
        assert tdk.w4_splits(8, K, N, 132) == {(2048, 5632): 3}.get(shape, 8)


@pytest.mark.parametrize("sms", [132, 114, 16, 1])
def test_w4_splits_fit_the_fixed_scratch(sms):
    """The sm90 B8's scratch is made once a stream and never grown: for
    every shape the rule splits, the tickets (one a tile) fit in 2 x SMs and
    the f32 partials (splits x M x N) in W4_PART_FLOATS_PER_SM a SM."""
    for M in (*range(1, 130), 200, 1000, 1024, 4096):
        for N in (64, 128, 192, 256, 320, 1024, 2048, 5632):
            for K in (8, 24, 200, 2048, 5632):
                splits = tdk.w4_splits(M, K, N, sms)
                if splits > 1:
                    tiles = -(-M // (16 * tdk.w4_slices(M))) * (N // tdk.W4_TILE_N)
                    assert tiles < 2 * sms and splits * M * N <= tdk.W4_PART_FLOATS_PER_SM * sms, (M, K, N)


def test_w4_route_rule():
    # from the dtype and shape alone, so it holds without a card
    sm90, first = tdk.W4_SM90_SOURCE, tdk.W4_FIRST_SOURCE
    assert tdk.w4_route(torch.bfloat16, 2048, 5632) == sm90
    assert tdk.w4_route(torch.float32, 2048, 5632) == first  # f32 (the identity probe) keeps the first design
    assert tdk.w4_route(torch.bfloat16, 64, 66) == first  # N not a multiple of 64
    assert tdk.w4_route(torch.bfloat16, 12, 64) == first  # K not a multiple of 8
    assert tdk.w4_route(torch.bfloat16, 2048, 256, first) == first
    for dtype, K, N, route in ((torch.float32, 2048, 256, sm90), (torch.bfloat16, 64, 66, sm90),
                               (torch.bfloat16, 2048, 256, "w4_matmul_sm80")):
        with pytest.raises(ValueError):
            tdk.w4_route(dtype, K, N, route)
    assert [tdk.w4_slices(M) for M in (1, 8, 16, 17, 40, 48, 49, 1024)] == [1, 1, 1, 2, 3, 3, 4, 4]


def test_w4_matmul_takes_the_plain_version_on_the_cpu_on_either_route():
    rng = np.random.default_rng(11)
    K, N = 64, 128
    (_, _), (tq, ts) = _pack_both(_randn(rng, 1, K, N))
    x = _t(_randn(rng, 8, K))
    before = dict(tdk.LAUNCHES)
    ref = tdk.w4_matmul_plain(x, tq[0], ts[0], (K, N), torch.bfloat16)
    for route in (None, tdk.W4_SM90_SOURCE, tdk.W4_FIRST_SOURCE):
        assert torch.equal(tdk.w4_matmul(x, tq[0], ts[0], (K, N), torch.bfloat16, route=route), ref)
    assert tdk.LAUNCHES == before


def test_w4_matmul_rejects_odd_columns(monkeypatch):
    # the kernel gives each thread a column pair, one packed byte: an odd
    # column count is refused on the card, at the wrapper and through the
    # forward's matmul site alike
    K, N = 16, 7
    assert not tdk.w4_matmul_supported((K, N))
    rng = np.random.default_rng(7)
    (jq, js), (tq, ts) = _pack_both(_randn(rng, 1, K, N))
    x = _randn(rng, 2, 3, K)
    # on the CPU the plain version takes any shape, as the JAX _wmul does
    ref = np.asarray(jllama._wmul(jnp.asarray(x), jllama.PackedW4(jnp.asarray(jq[0]), jnp.asarray(js[0]), (K, N)),
                                  jnp.float32, kernel="pallas"))
    out = tllama._wmul(_t(x), tllama.PackedW4(tq[0], ts[0], (K, N)), torch.float32)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6)
    # as a card tensor would: the wrapper raises before it launches
    monkeypatch.setattr(tdk, "_on_card", lambda *tensors: True)
    before = dict(tdk.LAUNCHES)
    with pytest.raises(ValueError, match="weight shape"):
        tdk.w4_matmul(_t(x[0]), tq[0], ts[0], (K, N), torch.float32)
    with pytest.raises(ValueError, match="weight shape"):
        tllama._wmul(_t(x), tllama.PackedW4(tq[0], ts[0], (K, N)), torch.float32)
    assert tdk.LAUNCHES == before


# ---------------------------------------------------------------------------
# the serving forward
# ---------------------------------------------------------------------------


def _np_params(cfg, seed):
    """Weights drawn with numpy: N(0, 0.02) projections, norms near 1."""
    rng = np.random.default_rng(seed)

    def make(name, shape):
        if isinstance(shape, dict):
            return {k: make(k, v) for k, v in shape.items()}
        if "norm" in name:
            return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        return (0.02 * rng.standard_normal(shape)).astype(np.float32)

    return make("", tllama.shapes(cfg))


def _jcfg(cfg):
    return jllama.LlamaConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})


def _w4_pair(params):
    """(JAX tree, port tree) with the stacked decoder matmuls packed."""
    jp = jax.tree.map(jnp.asarray, params)
    tp = params_from_numpy(params)
    for name, w in params["layers"].items():
        if w.ndim == 3:
            q, s = jax_pack(w)
            jp["layers"][name] = jllama.PackedW4(jnp.asarray(q), jnp.asarray(s), w.shape[1:])
            tq, ts = quant.pack_blockwise4_stacked(_t(w))
            tp["layers"][name] = tllama.PackedW4(tq, ts, w.shape[1:])
    return jp, tp


@pytest.fixture(params=["tiny", "2m"])
def model(request, tiny_cfg):
    if request.param == "tiny":
        return tllama.LlamaConfig.from_dict(tiny_cfg.to_dict())
    return load_config("2m")


@pytest.mark.parametrize("weight_format", ["fp32", "w4"])
def test_prefill_and_decode_logits_match_jax(model, weight_format):
    cfg = model
    params = _np_params(cfg, 3)
    if weight_format == "w4":
        jp, tp = _w4_pair(params)
    else:
        jp, tp = jax.tree.map(jnp.asarray, params), params_from_numpy(params)
    jcfg = _jcfg(cfg)
    rng = np.random.default_rng(5)
    P, n, S, T = 8, 6, 3, 16
    ids = np.zeros((1, P), np.int32)
    ids[0, :n] = rng.integers(1, cfg.vocab_size, n)
    f32 = dict(compute_dtype=jnp.float32)
    jl, jks, jvs = jllama.prefill_forward(jp, jnp.asarray(ids), jnp.int32(n), jcfg, **f32)
    for kernels in (True, False):
        tl, tks, tvs = tllama.prefill_forward(
            tp, _t(ids).long(), n, cfg, compute_dtype=torch.float32, kernels=kernels
        )
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
        np.testing.assert_allclose(tks.numpy(), np.asarray(jks), atol=1e-4)
        np.testing.assert_allclose(tvs.numpy(), np.asarray(jvs), atol=1e-4)

    # one decode step over a ring holding random history, with one slot
    # wrapped past T
    L, Kh, Dh = cfg.num_hidden_layers, cfg.kv_heads, cfg.head_dim
    ck, cv = _randn(rng, L, S, T, Kh, Dh), _randn(rng, L, S, T, Kh, Dh)
    toks = rng.integers(0, cfg.vocab_size, S).astype(np.int32)
    lens = np.asarray([0, 7, T + 5], np.int32)
    for kernel in ("pallas", "xla"):
        jlog, jck, _ = jllama.decode_forward(
            jp, jnp.asarray(toks), jnp.asarray(lens), jnp.asarray(ck), jnp.asarray(cv), jcfg,
            decode_kernel=kernel, **f32,
        )
        for kernels in (True, False):
            tck, tcv = _t(ck.copy()), _t(cv.copy())
            tlog, tck2, _ = tllama.decode_forward(
                tp, _t(toks).long(), _t(lens), tck, tcv, cfg,
                compute_dtype=torch.float32, kernels=kernels,
            )
            assert tck2 is tck  # written in place
            np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-4)
            np.testing.assert_allclose(tck.numpy(), np.asarray(jck), atol=1e-5)


def test_init_params_shapes_and_scheme():
    cfg = load_config("2m")
    g = torch.Generator().manual_seed(0)
    p = tllama.init_params(g, cfg, device="cpu")
    want = jax.tree.map(lambda s: tuple(s.shape), jllama.shapes(_jcfg(cfg)))
    assert jax.tree.map(lambda t: tuple(t.shape), p) == want
    assert torch.equal(p["final_norm"], torch.ones(cfg.hidden_size))
    std = float(p["embed_tokens"].std())
    assert abs(std - cfg.initializer_range) < 0.002


def test_configs_load_like_jax():
    from opendiloco_tpu.models.hf_io import load_config as jload

    for name in ("2m", "14m", "60m", "150m", "1b", "2m_4e", "150m_8e"):
        assert _jcfg(load_config(name)) == jload(name)
    cfg, params = get_model("1b")
    assert (cfg.hidden_size, cfg.kv_heads, cfg.head_dim, cfg.num_hidden_layers) == (2048, 4, 64, 22)
    assert params is None


def test_params_round_trip_bitwise(tiny_cfg):
    params = jax.device_get(jllama.init_params(jax.random.PRNGKey(1), tiny_cfg))
    back = params_to_numpy(params_from_numpy(params, device="cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
