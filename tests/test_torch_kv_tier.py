"""The host KV tier of the port's serving plane against the JAX package's.

The same numpy inputs, drawn from a seed, go to both packages at
``tiny_cfg`` size, f32 on the CPU (the port's kernel wrappers take their
plain versions; the JAX engine runs ``decode_kernel="xla"``). The
patterns are those of ``tests/test_kv_tier.py``: the tier's paused and
prefix stores (whose entries must be the JAX tier's byte for byte, under
``none`` and ``blockwise4bit``), the prefix-grid helpers, evict and
page-back under slot pressure (bit-exact token streams with codec
``none``), a host-prefix restore across a ring wrap, and the prefixes a
batcher advertises. Beyond the reference's tests: ``stop()`` and a cancel
with requests in the tier, a weight swap with prefix entries and paused
pages, speculative decode with the tier on, the config and assembly, and
a training run that serves with the tier.
"""
import json
import time
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opendiloco_tpu.config import ServeConfig as JServeConfig
from opendiloco_tpu.ops.attention import ring_live_rows as jring_live_rows
from opendiloco_tpu.serve.engine import ServeEngine as JServeEngine
from opendiloco_tpu.serve.kvcache import HostKVTier as JHostKVTier
from opendiloco_tpu.serve.kvcache import PREFIX_GRID as JPREFIX_GRID
from opendiloco_tpu.serve.kvcache import prefix_grid_lengths as jprefix_grid_lengths
from opendiloco_tpu.serve.kvcache import prefix_key as jprefix_key
from opendiloco_tpu.serve.scheduler import ContinuousBatcher as JBatcher
from opendiloco_torch.config import ServeConfig
from opendiloco_torch.models import llama as tllama
from opendiloco_torch.ops.attention import ring_live_rows
from opendiloco_torch.serve import ContinuousBatcher, HostKVTier, ServeEngine, build_serving
from opendiloco_torch.serve.kvcache import PREFIX_GRID, prefix_grid_lengths, prefix_key
from test_torch_hot_swap import _blobs, _run_two_workers
from test_torch_serve_engine import _np_params

torch.set_num_threads(2)

GEOM = dict(num_slots=4, max_context=64, prefill_buckets=(8, 16, 32))
CODECS = ["none", "blockwise4bit"]


@pytest.fixture
def cfg(tiny_cfg):
    return tllama.LlamaConfig.from_dict(tiny_cfg.to_dict())


def _port(cfg, params, **kw):
    return ServeEngine(cfg, params, compute_dtype=torch.float32, device="cpu", **{**GEOM, **kw})


def _jax(tiny_cfg, params, **kw):
    return JServeEngine(tiny_cfg, params, compute_dtype=jnp.float32, decode_kernel="xla", **{**GEOM, **kw})


def _wait_for(pred, timeout=30.0):
    """Prefix stores land on a later scheduler pass: poll, do not race."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError("condition never became true")


def _run_requests(batcher, prompts, max_new=8, timeout=120):
    reqs = [batcher.submit(p, max_new_tokens=max_new) for p in prompts]
    for r in reqs:
        assert r.wait(timeout), "request hung"
        assert r.error is None, r.error
    return [list(r.tokens) for r in reqs]


def _prompts(cfg, n, length=12, seed=11):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab_size, length).tolist() for _ in range(n)]


# ---------------------------------------------------------------------------
# HostKVTier, byte for byte the JAX tier
# ---------------------------------------------------------------------------


def _state(tier):
    """Everything a tier holds, in order: paused and prefix entries with
    their payloads, meta, shape, bytes and epoch, and the counters."""

    def entry(e):
        return (e.payload_k, e.payload_v, e.meta_k, e.meta_v, tuple(e.shape), e.raw_bytes, e.epoch)

    return (
        [(k, entry(e)) for k, e in tier._paused.items()],
        [(k, entry(e)) for k, e in tier._prefix.items()],
        tier.stats(),
    )


def _both(host_slots, codec):
    return HostKVTier(host_slots=host_slots, codec=codec), JHostKVTier(host_slots=host_slots, codec=codec)


@pytest.mark.parametrize("codec", CODECS)
def test_tier_paused_roundtrip_matches_jax(rng, codec):
    ours, ref = _both(4, codec)
    k = rng.standard_normal((2, 16, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 16, 2, 8)).astype(np.float32)
    for t in (ours, ref):
        t.put_paused(7, k, v)
    assert ours.paused_count == 1 and ours.stored_bytes() > 0
    assert _state(ours) == _state(ref)
    with pytest.raises(ValueError):
        ours.put_paused(7, k, v)  # a second pause of one request is a scheduler bug
    (rk, rv), (jk, jv) = ours.pop_paused(7), ref.pop_paused(7)
    assert rk.dtype == np.float32 and rk.shape == k.shape
    assert rk.tobytes() == jk.tobytes() and rv.tobytes() == jv.tobytes()
    if codec == "none":  # a bit-exact round trip
        np.testing.assert_array_equal(rk, k)
        np.testing.assert_array_equal(rv, v)
    assert ours.paused_count == 0 and not ours.drop_paused(7)
    assert _state(ours) == _state(ref)


@pytest.mark.parametrize("codec", CODECS)
def test_tier_pin_budget_reclaims_prefix_entries(rng, codec):
    ours, ref = _both(2, codec)
    k = rng.standard_normal((1, 8, 2, 4)).astype(np.float32)
    for t in (ours, ref):
        assert t.put_prefix("aa", 8, 0, k, k) and t.put_prefix("bb", 8, 0, k, k)
        assert t.prefix_count == 2
        # pinned pages preempt droppable prefix entries under budget
        t.put_paused(1, k, k)
        t.put_paused(2, k, k)
        assert t.paused_count == 2 and t.prefix_count == 0 and t.prefix_dropped == 2
        assert not t.can_pin()
        with pytest.raises(RuntimeError):
            t.put_paused(3, k, k)
        # all pinned: a prefix entry is declined and never evicts a pin
        assert not t.put_prefix("cc", 8, 0, k, k)
    assert _state(ours) == _state(ref)
    for t in (ours, ref):
        t.pop_paused(1)
        assert t.can_pin()
    assert _state(ours) == _state(ref)


@pytest.mark.parametrize("codec", CODECS)
def test_tier_prefix_epoch_invalidation_and_lru(rng, codec):
    ours, ref = _both(3, codec)
    k = rng.standard_normal((1, 8, 2, 4)).astype(np.float32)
    for t in (ours, ref):
        t.put_prefix("aa", 8, 0, k, k)
        got = t.get_prefix("aa", 8, 0)
        assert got is not None
        if codec == "none":
            np.testing.assert_array_equal(got[0], k)
        # a stale-epoch entry never serves and is deleted when touched
        assert t.get_prefix("aa", 8, 1) is None and t.prefix_count == 0
        # purge_stale sweeps without a lookup
        t.put_prefix("bb", 8, 0, k, k)
        t.put_prefix("cc", 8, 1, k, k)
        assert t.purge_stale(1) == 1
        assert t.resident_prefixes(1) == [["cc", 8]] and t.prefix_stale_purged == 2
        assert t.has_prefix("cc", 8, 1) and not t.has_prefix("cc", 8, 0)
        # least recently used leaves first when the budget fills
        t.put_prefix("dd", 8, 1, k, k)
        t.put_prefix("ee", 8, 1, k, k)
        t.put_prefix("ff", 8, 1, k, k)
        assert t.prefix_count == 3 and t.get_prefix("cc", 8, 1) is None
        # a hit refreshes an entry's recency
        assert t.get_prefix("dd", 8, 1) is not None
        t.put_prefix("gg", 8, 1, k, k)
        assert [kk for kk, _ in t.resident_prefixes(1)] == ["ff", "dd", "gg"]
    assert _state(ours) == _state(ref)
    assert abs(ours.occupancy() - 1.0) < 1e-12


def test_tier_blockwise4bit_restore_error_bounded(rng):
    ours, ref = _both(2, "blockwise4bit")
    k = rng.standard_normal((2, 32, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 32, 2, 8)).astype(np.float32)
    for t in (ours, ref):
        t.put_paused(1, k, v)
    assert _state(ours) == _state(ref)
    assert ours.stored_bytes() < (k.nbytes + v.nbytes) / 4
    rk, rv = ours.pop_paused(1)
    assert rk.shape == k.shape and rk.dtype == k.dtype
    # the reference's pinned bound: 4-bit blocks lose something, not much
    assert 0.0 < float(np.max(np.abs(rk - k))) < 0.35
    assert 0.0 < float(np.max(np.abs(rv - v))) < 0.35
    jk, jv = ref.pop_paused(1)
    assert rk.tobytes() == jk.tobytes() and rv.tobytes() == jv.tobytes()


def test_tier_refuses_like_jax():
    for cls in (HostKVTier, JHostKVTier):
        with pytest.raises(ValueError):
            cls(host_slots=0)
        with pytest.raises(ValueError):
            cls(codec="zstd")


def test_prefix_grid_helpers_match_jax():
    assert PREFIX_GRID == JPREFIX_GRID
    # grid lengths stay below the prompt length (the suffix keeps a token)
    # and descend, the lookup order
    assert prefix_grid_lengths(65) == [64, 32, 16]
    assert prefix_grid_lengths(64) == [32, 16]
    assert prefix_grid_lengths(16) == []
    for n in list(range(0, 80)) + [129, 1024, 1025, 2049, 5000]:
        assert prefix_grid_lengths(n) == jprefix_grid_lengths(n)
    rng = np.random.default_rng(3)
    for n in (17, 40, 300):
        prompt = rng.integers(0, 32000, n).tolist()
        for g in prefix_grid_lengths(n):
            assert prefix_key(prompt, g) == jprefix_key(prompt, g)
    a = prefix_key(list(range(100)), 32)
    assert a == prefix_key(list(range(32)) + [999], 32)  # exactly the first glen tokens
    assert a != prefix_key(list(range(100)), 64)
    for cache_len in (0, 1, 23, 24, 25, 100):
        assert ring_live_rows(cache_len, 24) == jring_live_rows(cache_len, 24)
    with pytest.raises(ValueError):
        ring_live_rows(-1, 24)


# ---------------------------------------------------------------------------
# the engine's page transfers
# ---------------------------------------------------------------------------


def test_page_rows_matches_jax(tiny_cfg, cfg):
    params = _np_params(cfg)
    ours, ref = _port(cfg, params), _jax(tiny_cfg, params)
    for rows in range(1, 65):
        assert ours.page_rows(rows) == ref.page_rows(rows)
    for bad in (0, 65):
        with pytest.raises(ValueError):
            ours.page_rows(bad)


def test_fetch_and_install_slot_pages_are_exact(cfg):
    """A fetch copies a slot's leading rows by value (padded to the page
    grid, f32); an install writes them back into another slot exactly."""
    params = _np_params(cfg, seed=2)
    engine = _port(cfg, params)
    prompt = _prompts(cfg, 1, length=11)[0]
    engine.admit(0, prompt)
    pk, pv = engine.fetch_slot_pages(0, len(prompt))
    assert pk.shape == (cfg.num_hidden_layers, 16, cfg.kv_heads, cfg.head_dim)
    want_k = engine.cache_k[:, 0, :16].numpy().copy()
    engine.admit(0, _prompts(cfg, 1, length=30, seed=5)[0])  # a new tenant cannot change the copy
    k, v = np.asarray(pk), np.asarray(pv)
    assert k.dtype == np.float32 and np.array_equal(k, want_k)
    engine.install_slot_pages(3, k, v)
    assert np.array_equal(engine.cache_k[:, 3, :16].numpy(), k)
    assert np.array_equal(engine.cache_v[:, 3, :16].numpy(), v)
    assert engine.stage_seconds["page_out"] > 0 and engine.stage_seconds["page_in"] > 0


def test_host_prefix_admit_matches_cold_prefill_and_jax(tiny_cfg, cfg):
    """admit(host_prefix=...) installs stored prefix rows and runs only the
    suffix: the prefix rows are the stored ones bit for bit, the first
    token and logits row those of a cold admit, and of the JAX engine's
    host-prefix admit on the same arrays."""
    params = _np_params(cfg, seed=4)
    prompt = _prompts(cfg, 1, length=26, seed=9)[0]
    glen = prefix_grid_lengths(len(prompt))[0]
    seed = _port(cfg, params)
    seed.admit(0, prompt[:glen] + [1, 2, 3])
    hk, hv = (np.asarray(p) for p in seed.fetch_slot_pages(0, glen))

    engine = _port(cfg, params)
    tok, row = engine.admit(1, prompt, host_prefix=(hk, hv, glen))
    assert np.array_equal(engine.cache_k[:, 1, :glen].numpy(), hk[:, :glen])
    assert np.array_equal(engine.cache_v[:, 1, :glen].numpy(), hv[:, :glen])
    cold_tok, cold_row = _port(cfg, params).admit(1, prompt)
    assert tok == cold_tok
    np.testing.assert_allclose(row, cold_row, atol=1e-5)
    jtok, jrow = _jax(tiny_cfg, params).admit(1, prompt, host_prefix=(hk, hv, glen))
    assert tok == jtok
    np.testing.assert_allclose(row, jrow, atol=1e-5)


# ---------------------------------------------------------------------------
# the batcher: evict, page back, host prefix store
# ---------------------------------------------------------------------------


def _tiered_vs_resident(cfg, *, tiered_slots, n_req, codec="none", quantum=2, **engine_kw):
    params = _np_params(cfg, seed=1)
    prompts = _prompts(cfg, n_req)
    ba = ContinuousBatcher(_port(cfg, params, num_slots=n_req, **engine_kw)).start()
    want = _run_requests(ba, prompts)
    ba.stop()
    tier = HostKVTier(host_slots=n_req + 2, codec=codec)
    bb = ContinuousBatcher(_port(cfg, params, num_slots=tiered_slots, **engine_kw), kv_tier=tier,
                           tier_quantum_steps=quantum, tier_min_resident_steps=1).start()
    got = _run_requests(bb, prompts)
    stats = bb.stats()
    bb.stop()
    return want, got, stats, prompts, params


def test_tier_on_no_pressure_is_bit_exact(cfg):
    # as many slots as requests: the tier is armed but never fires
    want, got, stats, _, _ = _tiered_vs_resident(cfg, tiered_slots=4, n_req=4)
    assert stats["tier"]["evictions"] == 0 and stats["tier"]["codec"] == "none"
    assert got == want


def test_evict_pageback_codec_none_is_bit_exact_and_matches_jax(tiny_cfg, cfg):
    """6 requests through 2 slots: evictions and page-backs must happen,
    and with codec none the streams equal the all-resident ones and the
    JAX tiered batcher's."""
    want, got, stats, prompts, params = _tiered_vs_resident(cfg, tiered_slots=2, n_req=6)
    tier = stats["tier"]
    assert tier["evictions"] > 0 and tier["resumes"] == tier["evictions"]
    assert tier["paused"] == 0 and tier["pages_out"] == tier["pages_in"] == tier["evictions"]
    assert got == want
    jb = JBatcher(_jax(tiny_cfg, params, num_slots=2), kv_tier=JHostKVTier(host_slots=8),
                  tier_quantum_steps=2, tier_min_resident_steps=1).start()
    try:
        jgot = _run_requests(jb, prompts)
        assert jb.stats()["tier"]["evictions"] > 0
    finally:
        jb.stop()
    assert got == jgot


def test_evict_pageback_blockwise4bit_completes(cfg):
    # quantized cold pages may move the streams, but every request completes
    want, got, stats, _, _ = _tiered_vs_resident(cfg, tiered_slots=2, n_req=6, codec="blockwise4bit")
    assert stats["tier"]["evictions"] > 0 and stats["tier"]["resumes"] == stats["tier"]["evictions"]
    assert stats["tier"]["codec"] == "blockwise4bit"
    assert [len(t) for t in got] == [len(t) for t in want]


def test_spec_decode_with_tier_is_bit_exact(cfg):
    """Speculative rounds over pages restored from the tier give the
    streams of the all-resident batcher (spec_k 2, draft 1 layer)."""
    want, got, stats, _, _ = _tiered_vs_resident(cfg, tiered_slots=2, n_req=6, spec_k=2, draft_layers=1)
    assert stats["tier"]["evictions"] > 0 and stats["spec"]["proposed"] > 0
    assert got == want


def test_host_prefix_restore_across_ring_wrap(tiny_cfg, cfg):
    """A host-tier prefix installed, then decoded past the ring's end: the
    restored rows behave as freshly prefilled ones under the lens masks
    (``ring_live_rows``), in both packages."""
    params = _np_params(cfg, seed=5)
    prompt = _prompts(cfg, 1, length=24, seed=5)[0]
    max_new = 16  # 24 + 16 = 40 > max_context 32: the ring wraps
    geom = dict(num_slots=2, max_context=32, prefill_buckets=(8, 16, 32))
    ba = ContinuousBatcher(_port(cfg, params, **geom)).start()
    want = _run_requests(ba, [prompt], max_new=max_new)
    ba.stop()
    glen = prefix_grid_lengths(len(prompt))[0]
    streams = {}
    for name, make_b, make_t in (("port", lambda: ContinuousBatcher(_port(cfg, params, **geom), kv_tier=tier,
                                                                      prefix_cache=True), HostKVTier),
                                 ("jax", lambda: JBatcher(_jax(tiny_cfg, params, **geom), kv_tier=tier,
                                                          prefix_cache=True), JHostKVTier)):
        tier = make_t(host_slots=4, codec="none")
        b = make_b().start()
        try:
            _run_requests(b, [prompt[:glen] + [1, 2]], max_new=2)  # seeds the store
            _wait_for(lambda: tier.prefix_count == 1)
            streams[name] = _run_requests(b, [prompt], max_new=max_new)
            assert b.stats()["prefix"]["host_hits"] == 1
        finally:
            b.stop()
    assert streams["port"] == want == streams["jax"]


def test_resident_prefixes_advertises_current_epoch(cfg):
    engine = _port(cfg, _np_params(cfg), num_slots=2)
    b = ContinuousBatcher(engine, kv_tier=HostKVTier(host_slots=4), prefix_cache=True)
    assert b.resident_prefixes() == []
    b.start()
    try:
        prompt = _prompts(cfg, 1, length=20, seed=9)[0]
        _run_requests(b, [prompt], max_new=2)
        _wait_for(lambda: b.resident_prefixes())
        assert b.resident_prefixes() == [[prefix_key(prompt, 16), 16]]
        assert b.stats()["tier"]["prefix_stores"] == 1
    finally:
        b.stop()
    assert ContinuousBatcher(engine).resident_prefixes() == []


def _manual_batcher(cfg, n_req=5, max_new=40, length=12, **kw):
    """A batcher driven by hand (no loop thread) through admission and
    decode until requests sit in the tier, paused and mid-page-out."""
    engine = _port(cfg, _np_params(cfg, seed=3), num_slots=2)
    tier = HostKVTier(host_slots=8)
    b = ContinuousBatcher(engine, kv_tier=tier, tier_quantum_steps=1, tier_min_resident_steps=1, **kw)
    reqs = [b.submit(p, max_new_tokens=max_new) for p in _prompts(cfg, n_req, length=length)]
    b._admit()
    b._decode()
    b._admit()  # evicts two for two queued requests
    b._finish_pageouts()
    b._decode()
    b._admit()  # one more queued request, then a rotation
    assert b._paused and b._pending_evict and len(b._active) == 2
    return b, tier, reqs


def test_stop_fails_paused_and_mid_pageout_requests(cfg):
    b, tier, reqs = _manual_batcher(cfg)
    t0 = time.monotonic()
    b.stop()
    assert time.monotonic() - t0 < 5
    for r in reqs:
        assert r.wait(0) and r.error == "server stopped"
    assert b.failed == len(reqs) and tier.paused_count == 0
    assert not b._paused and not b._pending_evict


def test_stop_with_a_running_loop_fails_tier_requests(cfg):
    """Long requests through 2 slots on the loop thread: stop() while some
    are in the tier fails every one of them, in bounded time."""
    engine = _port(cfg, _np_params(cfg, seed=3), num_slots=2)
    b = ContinuousBatcher(engine, kv_tier=HostKVTier(host_slots=8), tier_quantum_steps=1,
                          tier_min_resident_steps=1).start()
    reqs = [b.submit(p, max_new_tokens=400) for p in _prompts(cfg, 6)]
    _wait_for(lambda: b.evictions >= 4)
    t0 = time.monotonic()
    b.stop()
    assert time.monotonic() - t0 < 15
    for r in reqs:
        assert r.wait(0) and r.error == "server stopped"
    assert b.failed == 6 and b.kv_tier.paused_count == 0


def test_cancel_while_paused_drops_the_page(cfg):
    b, tier, reqs = _manual_batcher(cfg)
    b._finish_pageouts()
    rid = next(iter(b._paused))
    before = tier.paused_count
    req = b._paused[rid].req
    req.cancel()
    b._sweep_cancelled()
    assert req.wait(0) and req.error == "cancelled" and b.cancelled == 1
    assert rid not in b._paused and tier.paused_count == before - 1
    assert not tier.drop_paused(rid)
    b.stop()


def test_swap_purges_stale_prefixes_and_keeps_paused_pages(cfg):
    """A real hot swap (``ServeEngine.maybe_swap`` from a snapshot): the
    tier's prefix entries of the old weights go, its paused pages stay and
    resume into the new epoch's decode."""
    params1 = _np_params(cfg, seed=8)
    epoch = [0]
    b, tier, reqs = _manual_batcher(cfg, length=20, prefix_cache=True)
    b._finish_pageouts()
    assert tier.prefix_count > 0 and tier.paused_count > 0
    paused = tier.paused_count
    b.engine.snapshot_fn = lambda: (1, _blobs(params1, "fp16"), "fp16")
    b.engine.epoch_fn = lambda: epoch[0]
    b._maybe_swap()  # no lag: nothing happens
    assert b.engine.weights_epoch == 0 and tier.prefix_count > 0
    epoch[0] = 1
    b._maybe_swap()
    assert b.engine.weights_epoch == 1 and b.engine.swap_count == 1
    assert tier.prefix_count == 0 and tier.paused_count == paused
    assert tier.prefix_stale_purged > 0 and b.resident_prefixes() == []
    b.start()
    try:
        for r in reqs:
            assert r.wait(120) and r.error is None and len(r.tokens) == 40
    finally:
        b.stop()
    assert b.stats()["tier"]["resumes"] == b.stats()["tier"]["evictions"]


def test_health_and_stats_carry_the_tier(cfg):
    b, tier, reqs = _manual_batcher(cfg)
    h, s = b.health(), b.stats()
    assert h["tier_paused"] == len(b._paused) and h["tier_occupancy"] == round(tier.occupancy(), 4)
    assert s["tier"]["evictions"] == 4 and s["tier"]["paused_peak"] == 2
    assert s["prefix"]["host_hits"] == 0 and s["tier"]["host_slots"] == 8
    b.stop()
    plain = ContinuousBatcher(_port(cfg, _np_params(cfg), num_slots=2))
    assert "tier_paused" not in plain.health() and plain.stats()["tier"] is None


# ---------------------------------------------------------------------------
# config and assembly
# ---------------------------------------------------------------------------


def test_serve_config_tier_fields_like_jax():
    for kw in (dict(), dict(kv_tier=True, kv_tier_codec="blockwise4bit", kv_host_slots=5)):
        ref = JServeConfig(**kw)
        ours = ServeConfig(**kw)
        assert (ours.kv_tier, ours.kv_tier_codec, ours.kv_host_slots) == (
            ref.kv_tier, ref.kv_tier_codec, ref.kv_host_slots)
    for bad in (dict(kv_tier_codec="zstd"), dict(kv_host_slots=0)):
        with pytest.raises(ValueError):
            JServeConfig(**bad)
        with pytest.raises(ValueError):
            ServeConfig(**bad)


def test_build_serving_builds_the_tier(cfg, monkeypatch):
    """The config's tier fields, and the JAX package's environment
    overrides, reach the batcher's HostKVTier; /healthz reports it."""
    for var in ("ODTP_KV_TIER", "ODTP_KV_HOST_SLOTS", "ODTP_KV_TIER_CODEC"):
        monkeypatch.delenv(var, raising=False)
    params = _np_params(cfg)
    kw = dict(compute_dtype=torch.float32, device="cpu")
    scfg = ServeConfig(max_batch=2, max_context=64, prefill_buckets=[16], kv_tier=True,
                       kv_tier_codec="blockwise4bit", kv_host_slots=5)
    plane = build_serving(scfg, cfg, params, **kw)
    try:
        tier = plane.batcher.kv_tier
        assert isinstance(tier, HostKVTier) and (tier.host_slots, tier.codec_name) == (5, "blockwise4bit")
        r = plane.batcher.submit([1, 2, 3], max_new_tokens=3)
        assert r.wait(60) and r.error is None
        with urllib.request.urlopen(f"http://127.0.0.1:{plane.port}/healthz", timeout=30) as resp:
            health = json.loads(resp.read())
        assert health["tier_occupancy"] == 0.0 and health["tier_paused"] == 0
    finally:
        plane.stop()
    monkeypatch.setenv("ODTP_KV_HOST_SLOTS", "3")
    monkeypatch.setenv("ODTP_KV_TIER_CODEC", "none")
    plane = build_serving(scfg, cfg, params, start_server=False, **kw)
    plane.stop()
    assert (plane.batcher.kv_tier.host_slots, plane.batcher.kv_tier.codec_name) == (3, "none")
    monkeypatch.setenv("ODTP_KV_TIER", "0")
    plane = build_serving(scfg, cfg, params, start_server=False, **kw)
    plane.stop()
    assert plane.batcher.kv_tier is None
    monkeypatch.setenv("ODTP_KV_TIER", "1")
    plane = build_serving(ServeConfig(max_batch=2, max_context=64, prefill_buckets=[16]), cfg, params,
                          start_server=False, **kw)
    plane.stop()
    assert plane.batcher.kv_tier is not None and plane.batcher.kv_tier.host_slots == 3


def test_train_serves_with_the_tier_bit_for_bit(tmp_path, monkeypatch):
    """Worker 0 of a two-worker run serves with the tier and the prefix
    store on: the losses equal those of the run without serving bit for
    bit, swaps happen, and after the last swap the tier holds no prefix
    entry of older weights."""
    for var in ("ODTP_STATE_CODEC", "ODTP_KV_TIER", "ODTP_KV_HOST_SLOTS", "ODTP_KV_TIER_CODEC"):
        monkeypatch.delenv(var, raising=False)
    plain, _, _, _ = _run_two_workers(tmp_path, False, monkeypatch)
    served, responses, polled, planes = _run_two_workers(
        tmp_path, True, monkeypatch, serve_extra=dict(kv_tier=True, prefix_cache=True, kv_host_slots=4))
    assert served == plain
    ok = [r for r in responses if "error" not in r]
    assert ok and all(r["error"] == "server stopped" for r in responses if "error" in r)
    (plane,) = planes
    tier = plane.batcher.kv_tier
    assert isinstance(tier, HostKVTier) and plane.engine.swap_count >= 1
    assert all(e.epoch == plane.engine.weights_epoch for e in tier._prefix.values())
    assert any("tier_occupancy" in p for p in polled)
