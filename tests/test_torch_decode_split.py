"""B6's split-ring arithmetic, its split rule and route, and dw's route.

Paged decode attention (B6) runs on the card as the prefix-live instance
of B7's split kernel: the ring cut into splits across blocks, each
split's f32 partial (m, l, acc), then B7's merge in split order.
``paged_decode_attention_split_plain`` repeats that arithmetic in plain
PyTorch; here it is held against the JAX package's Pallas kernel in
interpret mode (as tests/test_decode_kernels.py runs it) and the port's
one-pass plain version, in f32 at atol 1e-5: the splits sum in another
order and rescale each partial by exp(m_split - m), a few f32 ulps of
outputs of magnitude about 1.

The split rule, B6's route rule and dw's route rule are decided from
static shapes and dtypes alone, so they are pinned here without a card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opendiloco_tpu.ops import decode_kernels as jdk
from opendiloco_torch.models.hf_io import load_config
from opendiloco_torch.ops import decode_kernels as tdk
from opendiloco_torch.ops import fused_xent as tfx

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("rep", [1, 2, 8])
@pytest.mark.parametrize("splits", [1, 3, 8])
def test_paged_decode_split_plain_matches_jax(splits, rep):
    S, T, Kh, D = 5, 32, 2, 16
    H = Kh * rep
    rng = np.random.default_rng(splits * 10 + rep)
    q = rng.standard_normal((S, H, D)).astype(np.float32)
    k, v = (rng.standard_normal((S, T, Kh, D)).astype(np.float32) for _ in range(2))
    _, chunk = tdk.spec_tail_split_chunk(T, splits)
    # empty slot, the live rows ending on a split edge, the last row,
    # exactly T, a wrapped ring
    lens = np.asarray([0, chunk - 1, T - 1, T, 2 * T + 1], np.int32)
    ref = np.asarray(jdk.paged_decode_attention(*map(jnp.asarray, (q, k, v, lens)), block_t=8, interpret=True))
    before = dict(tdk.LAUNCHES)
    out = tdk.paged_decode_attention_split_plain(_t(q), _t(k), _t(v), _t(lens), splits=splits).numpy()
    one = tdk.paged_decode_attention_plain(_t(q), _t(k), _t(v), _t(lens)).numpy()
    assert tdk.LAUNCHES == before
    assert tdk.spec_tail_split_chunk(T, splits)[0] == splits
    assert not np.isnan(out).any()
    np.testing.assert_allclose(out, ref, atol=1e-5)
    np.testing.assert_allclose(out, one, atol=1e-5)


def test_paged_decode_merge_plain_takes_nothing_from_dead_splits():
    # on the CPU the merge wrapper takes B7's plain merge at Kq 1: a split
    # past a slot's live rows (m = -inf, l = 0, acc = 0) adds exactly 0
    S, T, Kh, rep, D = 2, 32, 2, 4, 8
    g = torch.Generator().manual_seed(0)
    q = torch.randn(S, Kh * rep, D, generator=g)
    k, v = torch.randn(S, T, Kh, D, generator=g), torch.randn(S, T, Kh, D, generator=g)
    lens = torch.tensor([3, 20], dtype=torch.int32)  # slot 0 lives in split 0 of 4 alone
    out = tdk.paged_decode_attention_split_plain(q, k, v, lens, splits=4)
    ref = tdk.paged_decode_attention_plain(q, k, v, lens)
    assert out.shape == (S, Kh * rep, D) and bool(torch.isfinite(out).all())
    torch.testing.assert_close(out, ref, atol=1e-6, rtol=0)
    ml = torch.full((S, Kh, 3, rep, 2), float("-inf"))
    ml[..., 1] = 0.0
    ml[:, :, 1] = torch.tensor([0.5, 2.0])
    acc = torch.zeros(S, Kh, 3, rep, D)
    acc[:, :, 1] = 4.0
    merged = tdk.paged_decode_merge(ml, acc, torch.float32)
    assert merged.shape == (S, Kh * rep, D)
    torch.testing.assert_close(merged, torch.full_like(merged, 2.0), atol=0, rtol=0)


def test_paged_decode_split_rule():
    # config_1b's decode shape (S 8, T 1024, Kh 4, rep 8) on 132 SMs: B7's
    # rule with one query token gives 8 splits of 128 ring rows, 256
    # blocks, so every layer's B6 call merges once: 22 merges per decode
    # step (chip_smoke.py phases 4, 5 and 15 assert the same literal)
    cfg = load_config("1b")
    S, T, Kh, rep = 8, 1024, cfg.kv_heads, cfg.num_attention_heads // cfg.kv_heads
    assert (Kh, rep, cfg.head_dim) == (4, 8, 64)
    splits = tdk.spec_tail_splits(S, T, Kh, rep, 132)
    assert splits == 8
    assert tdk.spec_tail_split_chunk(T, splits) == (8, 128)
    assert tdk.spec_tail_rows_per_block(rep) == 16
    assert cfg.num_hidden_layers * (splits > 1) == 22
    # a ring of one split's rows, or query rows that fill the card alone,
    # take one split: no merge
    assert tdk.spec_tail_splits(8, 128, 4, 8, 132) == 1
    assert tdk.spec_tail_splits(64, 1024, 4, 8, 132) == 1


def test_paged_decode_route_rule():
    assert tdk._decode_route(64) == tdk.SPLIT_SOURCE
    assert tdk._decode_route(128) == tdk.SPLIT_SOURCE
    assert tdk._decode_route(136) == tdk.FIRST_SOURCE
    assert tdk._decode_route(256) == tdk.FIRST_SOURCE


def test_fused_xent_dw_route_rule():
    # dw shares dlog's and dh's rule: bf16 to the wgmma kernel, f32 to the
    # first design, and a forced sm90 route refuses f32
    assert tfx._route(torch.bfloat16) == tfx.SM90_SOURCE
    assert tfx._route(torch.float32) == tfx.SOURCE
    assert "fused_xent_dw_sm90" in tfx.SM90_NAMES and tfx.LAUNCHES["fused_xent_dw_sm90"] == 0
    with pytest.raises(ValueError):
        tfx._route(torch.float32, tfx.SM90_SOURCE)
    # on the CPU the wrapper takes the plain version whatever the route
    g = torch.Generator().manual_seed(1)
    h, dlog = torch.randn(40, 16, generator=g), torch.randn(40, 24, generator=g)
    acc = torch.zeros(16, 24)
    assert tfx.fused_xent_dw(h, dlog, acc, route=tfx.SM90_SOURCE) is acc
    torch.testing.assert_close(acc, h.T @ dlog, atol=1e-5, rtol=0)
