"""Speculative decode and shared-prefix reuse in the PyTorch port, against
the JAX package.

The same numpy inputs, drawn from a seed, go through the JAX function and
its counterpart in the port on the CPU, where each kernel wrapper takes its
plain version. Compared in f32:

- B7, the spec-tail attention: the port's ``spec_tail_attention`` and the
  kernel's plain version against the JAX ``spec_tail_attention`` and its
  Pallas kernel in interpret mode, over GQA ratios, ``q_start`` offsets,
  ragged ``lens`` with a wrapped ring (2T + 1), the draft's one-query shape
  and a one-slot suffix shape (atol 2e-6, as the JAX package's own test:
  the online softmax and the one-pass versions sum in different orders);
- ``verify_forward``, ``draft_propose``, ``spec_cache_insert``,
  ``prefix_copy`` and ``suffix_insert`` against JAX's, with the JAX side
  on both its ``decode_kernel="xla"`` and ``"pallas"`` (interpret) paths
  (logits and K/V atol 1e-5: f32 sums reassociate across two layers;
  proposals and cache writes exact);
- the host bookkeeping ``accept_counts`` and ``common_prefix_len``;
- engine and batcher: greedy token streams of spec decode equal the port's
  plain engine and the JAX engine (XLA path) token for token, across ring
  wrap, with an always-wrong draft and under the batcher; prefix reuse
  writes the prefix K/V rows a cold prefill writes, bit for bit;
- ``ServeConfig``'s spec validation against JAX's.

The CUDA kernel itself is held against its plain version on the card by
tests/test_torch_cuda_kernels.py and chip_smoke.py.
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opendiloco_tpu.config import ServeConfig as JServeConfig
from opendiloco_tpu.models import llama as jllama
from opendiloco_tpu.ops import attention as jattn
from opendiloco_tpu.ops import decode_kernels as jdk
from opendiloco_tpu.serve import kvcache as jkv
from opendiloco_tpu.serve.engine import ServeEngine as JServeEngine
from opendiloco_torch.config import ServeConfig
from opendiloco_torch.models import llama as tllama
from opendiloco_torch.models.convert import params_from_numpy
from opendiloco_torch.ops import attention as tattn
from opendiloco_torch.ops import decode_kernels as tdk
from opendiloco_torch.serve import ContinuousBatcher, Request, ServeEngine, build_serving
from opendiloco_torch.serve import kvcache as tkv
from test_torch_serve_engine import _generate, _np_params  # pytest puts tests/ on the path

torch.set_num_threads(2)


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# B7: spec-tail attention
# ---------------------------------------------------------------------------


def _b7_against_jax(q, ck, cv, tk, tv, lens, q_start):
    jargs = [jnp.asarray(a) for a in (q, ck, cv, tk, tv, lens)]
    ref = np.asarray(jattn.spec_tail_attention(*jargs, q_start=q_start))
    ref_kernel = np.asarray(
        jdk.spec_tail_attention_fused(*jargs, q_start=q_start, block_t=8, interpret=True)
    )
    targs = [_t(a) for a in (q, ck, cv, tk, tv, lens)]
    before = tdk.LAUNCHES.snapshot()
    fused = tdk.spec_tail_attention_fused(*targs, q_start=q_start).numpy()
    assert tdk.LAUNCHES.snapshot() == before  # the CPU takes the plain version: no launch
    plain = tdk.spec_tail_attention_plain(*targs, q_start=q_start).numpy()
    ours = tattn.spec_tail_attention(*targs, q_start=q_start).numpy()
    np.testing.assert_array_equal(fused, plain)
    np.testing.assert_allclose(plain, ref_kernel, atol=2e-6)
    np.testing.assert_allclose(plain, ref, atol=2e-6)
    np.testing.assert_allclose(ours, ref, atol=2e-6)


@pytest.mark.parametrize("q_start", [0, 1, 3])
@pytest.mark.parametrize("heads", [(8, 2), (4, 1), (4, 4)])
def test_spec_tail_attention_matches_jax(heads, q_start):
    H, Kh = heads
    S, T, Kq, D = 5, 32, 3, 16
    Kt = Kq + q_start  # the tail holds earlier draft rows before the queries
    rng = np.random.default_rng(q_start * 17 + H)
    q = _randn(rng, S, Kq, H, D)
    ck, cv = _randn(rng, S, T, Kh, D), _randn(rng, S, T, Kh, D)
    tk, tv = _randn(rng, S, Kt, Kh, D), _randn(rng, S, Kt, Kh, D)
    # empty slot, mid ring, the last rows, exactly T, a wrapped ring
    lens = np.asarray([0, 5, T - 2, T, 2 * T + 1], np.int32)
    _b7_against_jax(q, ck, cv, tk, tv, lens, q_start)


def test_spec_tail_attention_draft_shape_matches_jax():
    # the draft calls with one query against a k_steps-wide tail buffer
    S, T, H, Kh, D, k_steps = 3, 16, 4, 2, 16, 3
    rng = np.random.default_rng(7)
    q = _randn(rng, S, 1, H, D)
    ck, cv = _randn(rng, S, T, Kh, D), _randn(rng, S, T, Kh, D)
    tk, tv = _randn(rng, S, k_steps, Kh, D), _randn(rng, S, k_steps, Kh, D)
    lens = np.asarray([0, 9, 2 * T], np.int32)
    for i in range(k_steps):
        _b7_against_jax(q, ck, cv, tk, tv, lens, i)


def test_spec_tail_attention_suffix_shape_matches_jax():
    # the continued prefill: one slot, the suffix as the tail, Kq = Kt
    S, T, H, Kh, D, K = 1, 64, 8, 2, 16, 40
    rng = np.random.default_rng(8)
    q = _randn(rng, S, K, H, D)
    ck, cv = _randn(rng, S, T, Kh, D), _randn(rng, S, T, Kh, D)
    tk, tv = _randn(rng, S, K, Kh, D), _randn(rng, S, K, Kh, D)
    _b7_against_jax(q, ck, cv, tk, tv, np.asarray([21], np.int32), 0)


# (label, S, Kq, Kt, q_start, lens) at a 32-row ring: the verify, draft and
# suffix shapes. Cut into 2, 3 or 8 splits (16, 11 or 4 rows), the ring
# has whole splits that are empty (lens 0, lens 5), evicted (lens >= T at
# q_start 3: rows 0 .. 3, all of split 0 at 8 splits) or wrapped (2T + 1)
_SPLIT_SHAPES = [
    ("verify", 5, 5, 5, 0, [0, 5, 30, 32, 65]),
    ("draft", 5, 1, 4, 3, [0, 32, 35, 30, 65]),
    ("suffix", 1, 20, 20, 0, [21]),
]


@pytest.mark.parametrize("splits", [1, 2, 3, 8])
@pytest.mark.parametrize("shape", _SPLIT_SHAPES, ids=lambda s: s[0])
def test_spec_tail_split_plain_matches_jax(shape, splits):
    """The split-and-merge arithmetic of the B7 kernel (per-split partials,
    merged in split order) against the JAX kernel in interpret mode and the
    one-pass plain version, f32, atol 2e-6: the splits sum in another order
    and rescale each partial by exp(m_split - m), a few f32 ulps of outputs
    of magnitude about 1, as the one-pass version's 2e-6 against JAX."""
    _, S, Kq, Kt, q_start, lens = shape
    T, H, Kh, D = 32, 8, 2, 16
    rng = np.random.default_rng(splits * 31 + Kq)
    q = _randn(rng, S, Kq, H, D)
    ck, cv = _randn(rng, S, T, Kh, D), _randn(rng, S, T, Kh, D)
    tk, tv = _randn(rng, S, Kt, Kh, D), _randn(rng, S, Kt, Kh, D)
    lens = np.asarray(lens, np.int32)
    jargs = [jnp.asarray(a) for a in (q, ck, cv, tk, tv, lens)]
    ref = np.asarray(jdk.spec_tail_attention_fused(*jargs, q_start=q_start, block_t=8, interpret=True))
    targs = [_t(a) for a in (q, ck, cv, tk, tv, lens)]
    split = tdk.spec_tail_attention_split_plain(*targs, q_start=q_start, splits=splits).numpy()
    one = tdk.spec_tail_attention_plain(*targs, q_start=q_start).numpy()
    assert not np.isnan(split).any()
    assert tdk.spec_tail_split_chunk(T, splits)[0] == splits
    np.testing.assert_allclose(split, ref, atol=2e-6)
    np.testing.assert_allclose(split, one, atol=2e-6)


def test_spec_tail_merge_plain_takes_nothing_from_dead_splits():
    # a split with no live entry (m = -inf, l = 0, acc = 0) between live
    # ones, and a row whose every split is dead, give no NaN
    rng = np.random.default_rng(9)
    S, Kh, P, Kq, rep, D = 2, 2, 3, 2, 2, 8
    ml = torch.from_numpy(np.stack([_randn(rng, S, Kh, P, Kq * rep), np.abs(_randn(rng, S, Kh, P, Kq * rep))], -1))
    acc = _t(_randn(rng, S, Kh, P, Kq * rep, D))
    ml[:, :, 1, :, 0], ml[:, :, 1, :, 1], acc[:, :, 1] = float("-inf"), 0.0, 0.0
    ml[0, 0, :, 0, 0], ml[0, 0, :, 0, 1], acc[0, 0, :, 0] = float("-inf"), 0.0, 0.0
    out = tdk.spec_tail_merge_plain(ml, acc, Kq, torch.float32)
    keep = [0, 2]
    ref = tdk.spec_tail_merge_plain(ml[:, :, keep].contiguous(), acc[:, :, keep].contiguous(), Kq, torch.float32)
    assert not torch.isnan(out).any()
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    assert float(out[0, 0, 0].abs().max()) == 0.0  # kv head 0, row 0 of slot 0: nothing live


# ---------------------------------------------------------------------------
# host bookkeeping
# ---------------------------------------------------------------------------


def test_accept_counts_and_common_prefix_match_jax():
    rng = np.random.default_rng(3)
    for k in (1, 3, 4):
        draft = rng.integers(0, 3, (6, k)).astype(np.int32)
        verified = rng.integers(0, 3, (6, k + 1)).astype(np.int32)
        verified[0, :k] = draft[0]  # one slot accepts everything
        ours = tkv.accept_counts(draft, verified)
        assert ours.dtype == np.int32
        np.testing.assert_array_equal(ours, jkv.accept_counts(draft, verified))
        assert ours[0] == k
    with pytest.raises(ValueError):
        tkv.accept_counts(np.zeros((2, 3)), np.zeros((2, 3)))
    for a, b in (([1, 2, 3], [1, 2, 4]), ([], [1]), ([5, 6], [5, 6, 7]), ([1], [2])):
        assert tkv.common_prefix_len(a, b) == jkv.common_prefix_len(a, b)


# ---------------------------------------------------------------------------
# model functions
# ---------------------------------------------------------------------------


@pytest.fixture
def cfg(tiny_cfg):
    return tllama.LlamaConfig.from_dict(tiny_cfg.to_dict())


def _cache(cfg, rng, S, T):
    shape = (cfg.num_hidden_layers, S, T, cfg.kv_heads, cfg.head_dim)
    return _randn(rng, *shape), _randn(rng, *shape)


@pytest.mark.parametrize("kernel", ["xla", "pallas"])
def test_verify_forward_matches_jax(tiny_cfg, cfg, kernel):
    params = _np_params(cfg)
    rng = np.random.default_rng(5)
    S, T, K = 3, 16, 4
    ck, cv = _cache(cfg, rng, S, T)
    tail = rng.integers(1, cfg.vocab_size, (S, K)).astype(np.int32)
    lens = np.asarray([0, 7, 2 * T + 3], np.int32)  # empty, mid ring, wrapped
    jp = jax.tree.map(jnp.asarray, params)
    jl, jk, jv = jllama.verify_forward(
        jp, jnp.asarray(tail), jnp.asarray(lens), jnp.asarray(ck), jnp.asarray(cv), tiny_cfg,
        compute_dtype=jnp.float32, decode_kernel=kernel,
    )
    tl, tk, tv = tllama.verify_forward(
        params_from_numpy(params), _t(tail), _t(lens), _t(ck), _t(cv), cfg,
        compute_dtype=torch.float32,
    )
    assert tl.shape == (S, K, cfg.vocab_size) and tk.shape == (cfg.num_hidden_layers, S, K, cfg.kv_heads,
                                                              cfg.head_dim)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)
    plain = tllama.verify_forward(
        params_from_numpy(params), _t(tail), _t(lens), _t(ck), _t(cv), cfg,
        compute_dtype=torch.float32, kernels=False,
    )[0]
    np.testing.assert_allclose(plain.numpy(), np.asarray(jl), atol=1e-5)


@pytest.mark.parametrize("kernel", ["xla", "pallas"])
def test_draft_propose_matches_jax(tiny_cfg, cfg, kernel):
    params = _np_params(cfg, seed=1)
    rng = np.random.default_rng(6)
    S, T, k_steps = 3, 16, 3
    ck, cv = _cache(cfg, rng, S, T)
    tokens = rng.integers(1, cfg.vocab_size, S).astype(np.int32)
    lens = np.asarray([1, T - 2, 2 * T + 1], np.int32)
    ref = np.asarray(jllama.draft_propose(
        jax.tree.map(jnp.asarray, params), jnp.asarray(tokens), jnp.asarray(lens),
        jnp.asarray(ck), jnp.asarray(cv), tiny_cfg, k_steps=k_steps, draft_layers=1,
        compute_dtype=jnp.float32, decode_kernel=kernel,
    ))
    tck, tcv = _t(ck), _t(cv)
    for kernels in (True, False):
        got = tllama.draft_propose(
            params_from_numpy(params), _t(tokens), _t(lens), tck, tcv, cfg,
            k_steps=k_steps, draft_layers=1, compute_dtype=torch.float32, kernels=kernels,
        )
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(tck.numpy(), ck)  # the draft writes nothing into the ring
    with pytest.raises(ValueError):
        tllama.draft_propose(params_from_numpy(params), _t(tokens), _t(lens), tck, tcv, cfg,
                             k_steps=1, draft_layers=3, compute_dtype=torch.float32)


def test_spec_cache_insert_matches_jax(cfg):
    rng = np.random.default_rng(9)
    L, S, T, K = cfg.num_hidden_layers, 4, 8, 4
    ck, cv = _cache(cfg, rng, S, T)
    shape = (L, S, K, cfg.kv_heads, cfg.head_dim)
    tks, tvs = _randn(rng, *shape), _randn(rng, *shape)
    lens = np.asarray([0, 3, 6, 2 * T + 5], np.int32)  # the last two wrap while inserting
    accept = np.asarray([3, 0, 2, 1], np.int32)
    rk, rv = jllama.spec_cache_insert(*(jnp.asarray(a) for a in (ck, cv, tks, tvs, lens, accept)))
    tck, tcv = _t(ck.copy()), _t(cv.copy())
    out = tllama.spec_cache_insert(tck, tcv, _t(tks), _t(tvs), _t(lens), _t(accept))
    assert out[0] is tck and out[1] is tcv  # in place
    np.testing.assert_array_equal(tck.numpy(), np.asarray(rk))
    np.testing.assert_array_equal(tcv.numpy(), np.asarray(rv))
    with pytest.raises(ValueError):
        tllama.spec_cache_insert(tck, tcv, _t(np.zeros((L, S, T + 1, cfg.kv_heads, cfg.head_dim),
                                                       np.float32)),
                                 _t(np.zeros((L, S, T + 1, cfg.kv_heads, cfg.head_dim), np.float32)),
                                 _t(lens), _t(accept))


def test_prefix_copy_and_suffix_insert_match_jax(cfg):
    rng = np.random.default_rng(10)
    L, S, T = cfg.num_hidden_layers, 3, 16
    ck, cv = _cache(cfg, rng, S, T)
    rk, rv = jllama.prefix_copy(jnp.asarray(ck), jnp.asarray(cv), 2, 0, 5)
    tck, tcv = _t(ck.copy()), _t(cv.copy())
    tllama.prefix_copy(tck, tcv, 2, 0, 5)
    np.testing.assert_array_equal(tck.numpy(), np.asarray(rk))
    np.testing.assert_array_equal(tcv.numpy(), np.asarray(rv))

    P = 8  # a suffix bucket; count 6 real rows, written from row 5 (and one past the page)
    ks = _randn(rng, L, P, cfg.kv_heads, cfg.head_dim)
    vs = _randn(rng, L, P, cfg.kv_heads, cfg.head_dim)
    for start, count in ((5, 6), (12, 6)):
        rk2, rv2 = jllama.suffix_insert(rk, rv, jnp.asarray(ks), jnp.asarray(vs), 1, start, count)
        k2, v2 = tck.clone(), tcv.clone()
        tllama.suffix_insert(k2, v2, _t(ks), _t(vs), 1, start, count)
        np.testing.assert_array_equal(k2.numpy(), np.asarray(rk2))
        np.testing.assert_array_equal(v2.numpy(), np.asarray(rv2))


# ---------------------------------------------------------------------------
# engine and batcher
# ---------------------------------------------------------------------------


def _port_engine(cfg, params, **kw):
    kw.setdefault("num_slots", 4)
    kw.setdefault("max_context", 64)
    kw.setdefault("prefill_buckets", (8, 16, 32))
    return ServeEngine(cfg, params, compute_dtype=torch.float32, device="cpu", **kw)


def _jax_engine(tiny_cfg, params, **kw):
    kw.setdefault("num_slots", 4)
    kw.setdefault("max_context", 64)
    kw.setdefault("prefill_buckets", (8, 16, 32))
    return JServeEngine(tiny_cfg, params, compute_dtype=jnp.float32, decode_kernel="xla", **kw)


def _spec_generate(engine, prompt, n, slot=0):
    """Admit, then spec rounds of one slot; the first n greedy tokens.
    Each round gets fresh host arrays: the JAX engine's last device call
    of a round (the cache insert) is still in flight when spec_step
    returns, and on the CPU it may read the numpy buffers it was given."""
    tok, _ = engine.admit(slot, prompt)
    toks, S, cache_len = [tok], engine.num_slots, len(prompt)
    while len(toks) < n:
        lens, cur = np.zeros((S,), np.int32), np.zeros((S,), np.int32)
        lens[slot], cur[slot] = cache_len, toks[-1]
        g, m = engine.spec_step(cur, lens)
        take = int(m[slot]) + 1
        toks.extend(int(t) for t in g[slot, :take])
        cache_len += take
    return toks[:n]


@pytest.mark.parametrize("buckets,weight_format", [((8,), "fp32"), ((32,), "fp32"), ((8,), "w4")])
def test_spec_streams_match_plain_and_jax(tiny_cfg, cfg, buckets, weight_format):
    params = _np_params(cfg, seed=2)
    prompt = [5, 1, 4, 1, 5]
    plain = _generate(_port_engine(cfg, params, prefill_buckets=buckets, weight_format=weight_format),
                      prompt, 20)
    for k in (1, 3):
        spec = _port_engine(cfg, params, prefill_buckets=buckets, spec_k=k, weight_format=weight_format)
        assert spec.draft_layers == 1 and spec.tail_width == k + 1
        assert _spec_generate(spec, prompt, 20) == plain
        assert all(spec.stage_seconds[s] > 0 for s in ("prefill", "draft", "verify", "insert"))
    jspec = _jax_engine(tiny_cfg, params, prefill_buckets=buckets, spec_k=3, weight_format=weight_format)
    assert _spec_generate(jspec, prompt, 20) == plain


def test_spec_parity_across_ring_wrap(tiny_cfg, cfg):
    """3 + 24 tokens on a 16-row ring: the tail's K/V stays out of the
    ring until accepted, and the eviction mask reproduces the sliding
    window of the one-token loop."""
    params = _np_params(cfg, seed=3)
    geo = dict(max_context=16, prefill_buckets=(8,))
    plain = _generate(_port_engine(cfg, params, **geo), [1, 2, 3], 24)
    assert _spec_generate(_port_engine(cfg, params, spec_k=3, **geo), [1, 2, 3], 24) == plain
    assert _spec_generate(_jax_engine(tiny_cfg, params, spec_k=3, **geo), [1, 2, 3], 24) == plain


def test_spec_zero_acceptance_adversarial(cfg):
    """A draft that is always wrong: every round accepts nothing and emits
    the verify pass's corrected token, and the stream stays the plain one."""
    params = _np_params(cfg, seed=4)
    prompt, n = [2, 4, 6], 12
    ref = _generate(_port_engine(cfg, params), prompt, n)
    spec = _port_engine(cfg, params, spec_k=2)
    emitted = {"n": 1}  # admit produces ref[0]

    def adversary(tokens, lens):
        wrong = (ref[emitted["n"]] + 1) % cfg.vocab_size
        return np.full((spec.num_slots, spec.spec_k), wrong, np.int32)

    spec.propose_fn = adversary
    tok, _ = spec.admit(0, prompt)
    toks = [tok]
    while len(toks) < n:
        lens, cur = np.zeros((spec.num_slots,), np.int32), np.zeros((spec.num_slots,), np.int32)
        lens[0], cur[0] = len(prompt) + len(toks) - 1, toks[-1]
        g, m = spec.spec_step(cur, lens)
        assert int(m[0]) == 0
        toks.append(int(g[0, 0]))
        emitted["n"] += 1
    assert toks == ref


def _run(batcher, prompts, lengths):
    batcher.start()
    try:
        reqs = []
        for p, n in zip(prompts, lengths):
            reqs.append(batcher.submit(p, max_new_tokens=n))
            time.sleep(0.01)  # staggered: later prompts join a running batch
        for r in reqs:
            assert r.wait(120) and r.error is None
        return reqs
    finally:
        batcher.stop()


def test_spec_batcher_matches_isolated(cfg):
    params = _np_params(cfg, seed=5)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, 256, int(n)).tolist() for n in (3, 7, 5, 12)]
    lengths = [6, 9, 4, 7]
    batcher = ContinuousBatcher(_port_engine(cfg, params, num_slots=2, spec_k=3))
    reqs = _run(batcher, prompts, lengths)
    for req, p, n in zip(reqs, prompts, lengths):
        assert req.tokens == _generate(_port_engine(cfg, params, num_slots=1), p, n)
    st = batcher.stats()
    assert st["spec"]["proposed"] == batcher.spec_proposed > 0
    assert 0 <= batcher.spec_accepted <= batcher.spec_proposed
    assert st["failed"] == 0 and st["decode_steps"] > 0
    assert st["new_tokens"] == sum(n - 1 for n in lengths)


@pytest.mark.parametrize("src_tail,atol", [([30, 31, 32], 0.0), ([30, 31], 1e-6)])
def test_prefix_reuse_kv_rows_match_cold_prefill(cfg, src_tail, atol):
    """Reusing a live slot's prefix writes the K/V rows a cold prefill
    writes (causal attention makes them independent of the suffix), the
    suffix rows agree to f32 tolerance, and the stream equals a cold
    admit's. Bit for bit when the source prompt pads to the same bucket as
    the cold one; within 1e-6 when it pads to a shorter one, because the
    prefill's softmax sums its masked row over the bucket length and
    torch's CPU reduction associates a row of 8 otherwise than a row of
    16 (about 1e-7 apart in layer 1's K/V)."""
    params = _np_params(cfg, seed=6)
    sysp = [9, 8, 7, 6, 5, 4]
    p2 = sysp + [20, 21, 22]
    plen, n_new = len(sysp), 8
    cold = _port_engine(cfg, params)
    cold_toks = _generate(cold, p2, n_new, slot=1)

    engine = _port_engine(cfg, params)
    engine.admit(0, sysp + src_tail)  # the live source slot
    tok, row = engine.admit(1, p2, prefix_src=0, prefix_len=plen)
    _, cold_row = _port_engine(cfg, params).admit(1, p2)
    assert tok == cold_toks[0]
    np.testing.assert_allclose(row, cold_row, atol=1e-5)
    for warm, ref in ((engine.cache_k, cold.cache_k), (engine.cache_v, cold.cache_v)):
        np.testing.assert_allclose(warm[:, 1, :plen].numpy(), ref[:, 1, :plen].numpy(), atol=atol, rtol=0)
        # the suffix: verify_forward against the cold prefill's attention
        np.testing.assert_allclose(warm[:, 1, plen:len(p2)].numpy(), ref[:, 1, plen:len(p2)].numpy(),
                                   atol=2e-6, rtol=2e-5)
    toks, S = [tok], engine.num_slots
    lens, cur = np.zeros((S,), np.int32), np.zeros((S,), np.int32)
    lens[1], cur[1] = len(p2), tok
    for _ in range(n_new - 1):
        nxt, _ = engine.decode_step(cur, lens)
        toks.append(int(nxt[1]))
        lens[1] += 1
        cur[1] = toks[-1]
    assert toks == cold_toks


def test_prefix_batcher_hits_and_parity(cfg):
    params = _np_params(cfg, seed=7)
    sysp = list(range(1, 9))
    prompts = [sysp + [30, 31], sysp + [40], sysp + [50, 51, 52]]
    lengths = [12, 4, 6]
    for spec_k in (0, 2):
        batcher = ContinuousBatcher(_port_engine(cfg, params, spec_k=spec_k), prefix_cache=True)
        reqs = _run(batcher, prompts, lengths)
        for req, p, n in zip(reqs, prompts, lengths):
            assert req.tokens == _generate(_port_engine(cfg, params, num_slots=1), p, n)
        st = batcher.stats()
        assert st["prefix"]["hits"] == batcher.prefix_hits >= 1
        assert batcher.prefix_tokens_saved >= len(sysp) * batcher.prefix_hits


def test_find_prefix_rules(cfg):
    engine = _port_engine(cfg, _np_params(cfg), num_slots=3, max_context=32, spec_k=3)
    batcher = ContinuousBatcher(engine, prefix_cache=True)
    batcher._admit_into(0, Request(prompt=[1, 2, 3, 4, 5, 6], max_new_tokens=30))
    batcher._admit_into(1, Request(prompt=[1, 2, 3, 9], max_new_tokens=30))
    assert batcher.prefix_hits == 0  # 3 shared tokens < MIN_PREFIX_TOKENS
    # capped one short of the prompt, so the suffix pass has a token to run
    assert batcher._find_prefix([1, 2, 3, 4, 5]) == (0, 4)
    assert batcher._find_prefix([1, 2, 3, 4, 5, 6, 7]) == (0, 6)
    batcher._active[0].cache_len = 32 - engine.tail_width + 1  # too close to wrapping
    assert batcher._find_prefix([1, 2, 3, 4, 5, 6, 7]) == (None, 0)


@pytest.mark.parametrize(
    "bad",
    [dict(spec_decode_k=-1), dict(draft_layers=-1), dict(max_context=32, prefill_buckets=[16],
                                                         spec_decode_k=32)],
)
def test_serve_config_spec_validation_like_jax(bad):
    with pytest.raises(ValueError):
        JServeConfig(**bad)
    with pytest.raises(ValueError):
        ServeConfig(**bad)


def test_serve_config_spec_defaults_match_jax():
    ours, ref = ServeConfig(), JServeConfig()
    for f in ("spec_decode_k", "draft_layers", "prefix_cache"):
        assert getattr(ours, f) == getattr(ref, f)
    ok = dict(max_context=32, prefill_buckets=[16], spec_decode_k=31, draft_layers=3, prefix_cache=True)
    assert JServeConfig(**ok).spec_decode_k == ServeConfig(**ok).spec_decode_k == 31


def test_build_serving_passes_spec_and_prefix(cfg):
    params = _np_params(cfg, seed=8)
    serve_cfg = ServeConfig(max_batch=2, max_context=32, prefill_buckets=[8, 16], spec_decode_k=2,
                            draft_layers=1, prefix_cache=True)
    sysp = [3, 1, 4, 1, 5, 9]
    plane = build_serving(serve_cfg, cfg, params, compute_dtype=torch.float32, device="cpu", start_server=False)
    try:
        assert (plane.engine.spec_k, plane.engine.draft_layers) == (2, 1)
        assert plane.batcher.prefix_cache and plane.batcher.spec_decode
        reqs = [plane.batcher.submit(sysp + [t], max_new_tokens=6) for t in (7, 8)]
        assert all(r.wait(60) and r.error is None for r in reqs)
    finally:
        plane.stop()
    for r, t in zip(reqs, (7, 8)):
        assert r.tokens == _generate(_port_engine(cfg, params, num_slots=1), sysp + [t], 6)
    assert plane.batcher.prefix_hits == 1


def test_kernel_probe_times_each_kernel(cfg):
    for fmt, keys in (("fp32", {"decode_attn_us", "verify_attn_us"}),
                      ("w4", {"decode_attn_us", "verify_attn_us", "w4_matmul_us"})):
        engine = _port_engine(cfg, _np_params(cfg), spec_k=2, weight_format=fmt)
        before = tdk.LAUNCHES.snapshot()
        got = engine.kernel_probe(iters=2)
        assert set(got) == keys and all(v > 0 for v in got.values())
        assert tdk.LAUNCHES.snapshot() == before  # plain versions on the CPU
