"""Engine- and batcher-level parity of the PyTorch serving plane with the
JAX package.

Both packages get the same weights, drawn with numpy from a seed. The port
runs on the CPU in f32 (its kernel wrappers take their plain versions);
the JAX engine runs with ``decode_kernel="pallas"`` (interpret mode) and
with ``"xla"``. Greedy token streams must be identical, token for token,
with a T=24 ring that the streams wrap, as
``tests/test_decode_kernels.py::test_engine_token_streams_identical``
does for the two JAX paths.
"""
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opendiloco_tpu.config import ServeConfig as JServeConfig
from opendiloco_tpu.diloco.compression import pack_blockwise4_stacked as jax_pack
from opendiloco_tpu.serve.engine import ServeEngine as JServeEngine
from opendiloco_tpu.serve.scheduler import ContinuousBatcher as JBatcher
from opendiloco_torch import quant
from opendiloco_torch.config import ServeConfig
from opendiloco_torch.models import llama as tllama
from opendiloco_torch.serve import ContinuousBatcher, ServeEngine, build_serving

torch.set_num_threads(2)

GEOMETRY = dict(num_slots=2, max_context=24, prefill_buckets=(8, 16))


def _np_params(cfg, seed=0):
    rng = np.random.default_rng(seed)

    def make(name, shape):
        if isinstance(shape, dict):
            return {k: make(k, v) for k, v in shape.items()}
        if "norm" in name:
            return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        return (0.02 * rng.standard_normal(shape)).astype(np.float32)

    return make("", tllama.shapes(cfg))


@pytest.fixture
def cfg(tiny_cfg):
    return tllama.LlamaConfig.from_dict(tiny_cfg.to_dict())


def _jax_engine(tiny_cfg, params, kernel, **kw):
    return JServeEngine(
        tiny_cfg, params, compute_dtype=jnp.float32, decode_kernel=kernel, **{**GEOMETRY, **kw}
    )


def _port_engine(cfg, params, **kw):
    return ServeEngine(cfg, params, compute_dtype=torch.float32, device="cpu", **{**GEOMETRY, **kw})


def _generate(engine, prompt, n, slot=0):
    tok, _ = engine.admit(slot, prompt)
    toks = [tok]
    cache_len = len(prompt)
    S = engine.num_slots
    for _ in range(n - 1):
        tokens = np.zeros((S,), np.int32)
        lens = np.zeros((S,), np.int32)
        tokens[slot], lens[slot] = toks[-1], cache_len
        nxt, _ = engine.decode_step(tokens, lens)
        toks.append(int(nxt[slot]))
        cache_len += 1
    return toks


@pytest.mark.parametrize("weight_format", ["fp32", "w4"])
def test_engine_token_streams_match_jax(tiny_cfg, cfg, weight_format):
    params = _np_params(cfg)
    rng = np.random.default_rng(11)
    # both prefill buckets, and enough new tokens to wrap the T=24 ring
    prompts = [rng.integers(1, 256, 5).tolist(), rng.integers(1, 256, 12).tolist()]
    port = _port_engine(cfg, params, weight_format=weight_format)
    streams = {}
    for kernel in ("pallas", "xla"):
        eng = _jax_engine(tiny_cfg, params, kernel, weight_format=weight_format)
        streams[kernel] = [_generate(eng, p, 20, slot=i) for i, p in enumerate(prompts)]
    ours = [_generate(port, p, 20, slot=i) for i, p in enumerate(prompts)]
    assert ours == streams["pallas"] == streams["xla"]
    assert port.stage_seconds["prefill"] > 0 and port.stage_seconds["decode"] > 0


def test_w4_engine_packs_like_jax(tiny_cfg, cfg):
    params = _np_params(cfg)
    port = _port_engine(cfg, params, weight_format="w4")
    jeng = _jax_engine(tiny_cfg, params, "xla", weight_format="w4")
    for name, w in params["layers"].items():
        got = port.params["layers"][name]
        if w.ndim != 3:
            assert isinstance(got, torch.Tensor)
            continue
        jq, js = jax_pack(w)
        assert isinstance(got, tllama.PackedW4) and got.shape == w.shape[1:]
        np.testing.assert_array_equal(got.q.numpy(), jq)
        np.testing.assert_array_equal(got.s.numpy().view(np.uint16), js)
        np.testing.assert_array_equal(np.asarray(jeng.params["layers"][name].q), jq)
    assert not isinstance(port.params["embed_tokens"], tllama.PackedW4)


def _run_batcher(batcher, prompts, **submit):
    batcher.start()
    try:
        reqs = []
        for p in prompts:
            reqs.append(batcher.submit(p, **submit))
            time.sleep(0.01)  # staggered: later prompts join a running batch
        for r in reqs:
            assert r.wait(120)
        return reqs
    finally:
        batcher.stop()


def test_batcher_token_lists_match_jax(tiny_cfg, cfg):
    params = _np_params(cfg, seed=1)
    rng = np.random.default_rng(17)
    prompts = [rng.integers(1, 256, n).tolist() for n in (4, 9, 14)]
    jreqs = _run_batcher(JBatcher(_jax_engine(tiny_cfg, params, "xla", num_slots=2)), prompts,
                         max_new_tokens=8)
    port = ContinuousBatcher(_port_engine(cfg, params, num_slots=2))
    treqs = _run_batcher(port, prompts, max_new_tokens=8)
    assert all(r.error is None for r in jreqs + treqs)
    assert [r.tokens for r in treqs] == [r.tokens for r in jreqs]
    st = port.stats()
    assert (st["completed"], st["failed"], st["new_tokens"]) == (3, 0, 3 * 7)
    assert all(st["ttft_ms"][q] > 0 for q in ("p50", "p99"))
    assert 0 < st["latency_ms"]["p50"] <= st["latency_ms"]["p99"]

    # eos: stop at a token the stream is known to produce, and drop it
    eos = jreqs[0].tokens[3]
    j_eos = _run_batcher(JBatcher(_jax_engine(tiny_cfg, params, "xla")), prompts[:1],
                         max_new_tokens=8, eos_id=eos)
    t_eos = _run_batcher(ContinuousBatcher(_port_engine(cfg, params)), prompts[:1],
                         max_new_tokens=8, eos_id=eos)
    want = jreqs[0].tokens[: jreqs[0].tokens.index(eos)]
    assert t_eos[0].tokens == j_eos[0].tokens == want


def _schema(tree, data_keyed=("stages_s", "staleness_hist")):
    """The nested key set of a stats() dict. Maps keyed by data (stage
    names, staleness values) are leaves: their keys are not schema."""
    keys = set()
    for k, v in tree.items():
        keys.add(k)
        if isinstance(v, dict) and k not in data_keyed:
            keys |= {f"{k}.{sub}" for sub in _schema(v, ())}
    return keys


def test_batcher_stats_schema_matches_jax(tiny_cfg, cfg):
    params = _np_params(cfg, seed=2)
    rng = np.random.default_rng(23)
    prompts = [rng.integers(1, 256, n).tolist() for n in (5, 11, 3)]
    jax_b = JBatcher(_jax_engine(tiny_cfg, params, "xla", num_slots=2))
    port = ContinuousBatcher(_port_engine(cfg, params, num_slots=2))
    _run_batcher(jax_b, prompts, max_new_tokens=6)
    _run_batcher(port, prompts, max_new_tokens=6)
    want, got = jax_b.stats(), port.stats()
    assert _schema(got) == _schema(want)
    assert (got["new_tokens"], got["completed"]) == (want["new_tokens"], want["completed"]) == (3 * 5, 3)
    assert set(got["stages_s"]) <= set(want["stages_s"])
    assert all(v == round(v, 6) for v in got["stages_s"].values())
    for key, qs in (("latency_ms", ("p50", "p90", "p99", "mean")), ("ttft_ms", ("p50", "p99"))):
        assert all(got[key][q] > 0 for q in qs)
    assert (got["weight_swaps"], got["weights_epoch"], got["tier"]) == (0, 0, None)


def test_batcher_reject_paths_match_jax(tiny_cfg, cfg):
    params = _np_params(cfg)
    batchers = [
        JBatcher(_jax_engine(tiny_cfg, params, "xla"), max_queue=1),
        ContinuousBatcher(_port_engine(cfg, params), max_queue=1),
    ]
    errors = []
    for b in batchers:  # the loop is not started: submits stay queued
        got = [
            b.submit([], max_new_tokens=4).error,
            b.submit(list(range(1, 18)), max_new_tokens=4).error,  # > bucket 16
            b.submit([1, 2], max_new_tokens=0).error,
            b.submit([1, 2], max_new_tokens=4).error,  # queued
            b.submit([1, 2], max_new_tokens=4).error,  # queue full
            b.submit([1, 2], deadline_ms=0).error,
        ]
        b.stop()
        got.append(b.submit([1, 2]).error)
        errors.append((got, b.rejected, b.failed, b.shed))
    assert errors[0] == errors[1]
    assert errors[1][0] == [
        "empty prompt",
        "prompt length 17 exceeds max prefill bucket",
        "max_new_tokens must be >= 1",
        None,
        "queue full",
        "deadline exceeded",
        "server stopped",
    ]


def test_batcher_sweeps_cancelled_and_expired_like_jax(tiny_cfg, cfg):
    params = _np_params(cfg)
    outcomes = []
    for b in (
        JBatcher(_jax_engine(tiny_cfg, params, "xla", num_slots=1)),
        ContinuousBatcher(_port_engine(cfg, params, num_slots=1)),
    ):
        gone = b.submit([1, 2, 3], max_new_tokens=4)
        late = b.submit([4, 5], max_new_tokens=4, deadline_ms=1)
        first = b.submit([6, 7], max_new_tokens=3, priority=-1)
        then = b.submit([8, 9], max_new_tokens=2)
        gone.cancel()
        time.sleep(0.01)  # past the deadline before the loop starts
        b.start()
        try:
            assert all(r.wait(60) for r in (gone, late, first, then))
        finally:
            b.stop()
        reqs = (gone, late, first, then)
        outcomes.append(([r.error for r in reqs], [r.tokens for r in reqs], b.cancelled, b.shed,
                         b.completed, first.t_first < then.t_first))
    assert outcomes[0] == outcomes[1]
    assert outcomes[1][0] == ["cancelled", "deadline exceeded", None, None]
    assert outcomes[1][-1]  # the lower priority tier was admitted first


def test_loop_error_fails_every_client(cfg):
    engine = _port_engine(cfg, _np_params(cfg))

    def broken(tokens, lens):
        raise RuntimeError("boom")

    engine.decode_step = broken
    batcher = ContinuousBatcher(engine)
    reqs = [batcher.submit(p, max_new_tokens=4) for p in ([1, 2, 3], [4, 5], [6])]
    batcher.start()  # two requests take the slots, the third stays queued
    try:
        assert all(r.wait(60) for r in reqs)
    finally:
        batcher.stop()
    assert [r.error for r in reqs] == ["RuntimeError: boom"] * 3
    assert batcher.stats()["loop_error"] == "RuntimeError: boom"


def test_build_serving_on_cpu_matches_engine(cfg):
    params = _np_params(cfg, seed=2)
    serve_cfg = ServeConfig(max_batch=2, max_context=24, prefill_buckets=[8, 16])
    prompt = [3, 1, 4, 1, 5, 9]
    want = _generate(_port_engine(cfg, params), prompt, 6)
    plane = build_serving(serve_cfg, cfg, params, compute_dtype=torch.float32, device="cpu", start_server=False)
    try:
        req = plane.batcher.submit(prompt, max_new_tokens=6)
        assert req.wait(60) and req.error is None
        assert req.tokens == want
        assert plane.engine.device.type == "cpu"
    finally:
        plane.stop()


@pytest.mark.parametrize(
    "bad",
    [
        dict(max_batch=0),
        dict(prefill_buckets=[]),
        dict(prefill_buckets=[0, 8]),
        dict(max_context=32, prefill_buckets=[8, 64]),
        dict(weight_format="int8"),
    ],
)
def test_serve_config_validates_like_jax(bad):
    with pytest.raises(ValueError):
        JServeConfig(**bad)
    with pytest.raises(ValueError):
        ServeConfig(**bad)


def test_serve_config_defaults_match_jax():
    ours, ref = ServeConfig(), JServeConfig()
    for f in ("max_batch", "max_context", "prefill_buckets", "max_queue", "weight_format", "host", "port",
              "swap_every_steps", "max_stale_rounds"):
        assert getattr(ours, f) == getattr(ref, f)
    assert ServeConfig(prefill_buckets="8, 16").prefill_buckets == [8, 16]


def test_entry_points_raise_without_a_card(cfg, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = _np_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(cfg, params)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_serving(ServeConfig(max_context=16, prefill_buckets=[16]), cfg, params)
    with pytest.raises(RuntimeError, match="CUDA"):
        tllama.init_params(torch.Generator(), cfg, device="cuda")


@pytest.mark.parametrize("kwargs", [dict(snapshot_fn=lambda: None), dict(max_stale_rounds=1)])
def test_hot_swap_arguments_are_taken(cfg, kwargs):
    # hot swap is ported: the engine takes its arguments and, with no
    # epoch source, reports no staleness and does not swap
    engine = _port_engine(cfg, _np_params(cfg), **kwargs)
    assert engine.staleness() == 0 and engine.maybe_swap() is False
    assert engine.max_stale_rounds == kwargs.get("max_stale_rounds", 0)


@pytest.mark.parametrize(
    "kwargs",
    [dict(spec_k=-1), dict(spec_k=2, draft_layers=2), dict(spec_k=24)],
    ids=["negative spec_k", "draft_layers = L", "spec_k + 1 > max_context"],
)
def test_engine_spec_validation_like_jax(tiny_cfg, cfg, kwargs):
    params = _np_params(cfg)
    with pytest.raises(ValueError):
        _jax_engine(tiny_cfg, params, "xla", **kwargs)
    with pytest.raises(ValueError):
        _port_engine(cfg, params, **kwargs)


def test_later_slice_paths_raise_not_implemented(cfg):
    # the KV tier is a later slice; install_wire, a DiLoCo optimizer and
    # the front end are ported (tests/test_torch_hot_swap.py and
    # tests/test_torch_server.py hold them against the JAX package)
    engine = _port_engine(cfg, _np_params(cfg))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        engine.admit(0, [1, 2, 3], host_prefix=(None, None, 2))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ContinuousBatcher(engine, kv_tier=object())
    with pytest.raises(ValueError, match="leaves"):
        engine.install_wire(1, [], "fp16")


def test_install_params_rebinds(cfg):
    p0, p1 = _np_params(cfg, seed=0), _np_params(cfg, seed=5)
    engine = _port_engine(cfg, p0)
    engine.install_params(3, p1)
    assert (engine.weights_epoch, engine.swap_count) == (3, 1)
    assert _generate(engine, [7, 8, 9], 4) == _generate(_port_engine(cfg, p1), [7, 8, 9], 4)


def test_packer_runs_per_layer_on_stacked_leaves():
    w = torch.randn(3, 16, 8, generator=torch.Generator().manual_seed(0))
    q, s = quant.pack_blockwise4_stacked(w)
    assert q.shape == (3, 64) and s.shape == (3, 1)
    for i in range(3):
        qi, si = quant.pack_blockwise4_stacked(w[i : i + 1])
        assert torch.equal(qi[0], q[i]) and torch.equal(si[0], s[i])
