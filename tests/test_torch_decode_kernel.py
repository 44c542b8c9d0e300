"""``ServeConfig.decode_kernel`` in the port, against the JAX package, on
the CPU.

The field parses and validates as the JAX package's does, and
``ODTP_DECODE_KERNEL`` wins over it in ``build_serving`` as there. "auto"
takes the kernels on the card and their plain versions elsewhere; "xla"
the plain versions on any device; "pallas" forces the kernels, which a CPU
engine cannot run, so it raises there instead of running the plain path
under the kernel's name. Every serving forward threads the choice to each
kernel call site: with ``kernels=False`` no wrapper is called at all (on
the card: no B6, B7 or B8 launch). Token streams under "auto" and "xla"
equal each other and the JAX engine's (``decode_kernel="xla"``) token for
token, plain and speculative, fp32 and w4 weights.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opendiloco_tpu.config import Config as JConfig
from opendiloco_tpu.config import parse_argv as jparse_argv
from opendiloco_tpu.serve.engine import ServeEngine as JServeEngine
from opendiloco_torch import obs
from opendiloco_torch.config import Config, ServeConfig, parse_argv
from opendiloco_torch.models import llama as tllama
from opendiloco_torch.serve import ServeEngine, build_serving

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


@pytest.mark.parametrize("value", ["auto", "pallas", "xla"])
def test_field_parses_as_the_jax_config(value):
    argv = ["--serve.enabled", "--serve.decode-kernel", value]
    assert parse_argv(argv) == jparse_argv(argv)
    assert Config(**parse_argv(argv)).serve.decode_kernel == JConfig(**jparse_argv(argv)).serve.decode_kernel == value
    assert ServeConfig().decode_kernel == JConfig(serve={}).serve.decode_kernel == "auto"


def test_unknown_value_is_refused_as_the_jax_config_refuses():
    with pytest.raises(ValueError, match="decode_kernel"):
        ServeConfig(decode_kernel="triton")
    with pytest.raises(Exception):
        JConfig(serve={"decode_kernel": "triton"})


def test_pallas_on_a_cpu_engine_raises(cfg):
    with pytest.raises(ValueError, match="decode_kernel"):
        ServeEngine(cfg, _np_params(cfg), device="cpu", decode_kernel="pallas", **GEOMETRY)
    with pytest.raises(ValueError, match="decode_kernel"):
        build_serving(ServeConfig(decode_kernel="pallas", max_context=24, prefill_buckets=[8, 16]), cfg,
                      _np_params(cfg), device="cpu", start_server=False)


@pytest.mark.parametrize("env,field,want", [("xla", "pallas", "xla"), ("", "xla", "xla"), ("", "auto", "xla"),
                                            ("pallas", "xla", None)])
def test_environment_variable_wins_over_the_config(monkeypatch, cfg, env, field, want):
    monkeypatch.setenv("ODTP_DECODE_KERNEL", env)
    sc = ServeConfig(decode_kernel=field, max_batch=2, max_context=24, prefill_buckets=[8, 16])
    if want is None:  # the variable forces the kernels, which the CPU cannot run
        with pytest.raises(ValueError, match="decode_kernel"):
            build_serving(sc, cfg, _np_params(cfg), device="cpu", start_server=False)
        return
    plane = build_serving(sc, cfg, _np_params(cfg), device="cpu", start_server=False)
    try:
        assert plane.engine.decode_kernel == want
    finally:
        plane.stop()


@pytest.fixture
def wrapper_calls(monkeypatch):
    """Counters on the three kernel wrappers as the serving forwards call them."""
    calls = {"paged_decode_attention": 0, "spec_tail_attention_fused": 0, "w4_matmul": 0}
    for name in calls:
        fn = getattr(tllama, name)

        def counted(*args, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*args, **kw)

        monkeypatch.setattr(tllama, name, counted)
    return calls


@pytest.mark.parametrize("kernels", [True, False])
def test_every_call_site_threads_the_choice(cfg, wrapper_calls, kernels):
    """prefill, decode, verify and draft over w4 weights: with the kernels
    each wrapper runs where the path needs it (7 weight products a layer,
    one attention a layer and draft step); without them none runs."""
    engine = ServeEngine(cfg, _np_params(cfg), device="cpu", weight_format="w4", spec_k=2,
                         decode_kernel="auto", **GEOMETRY)
    params, cd, L = engine.params, torch.float32, cfg.num_hidden_layers
    S = engine.num_slots
    ids = torch.arange(8).reshape(1, 8)
    tllama.prefill_forward(params, ids, 8, cfg, compute_dtype=cd, kernels=kernels)
    lens = torch.full((S,), 8, dtype=torch.int32)
    tokens = torch.ones(S, dtype=torch.int64)
    tllama.decode_forward(params, tokens, lens, engine.cache_k, engine.cache_v, cfg, compute_dtype=cd,
                          kernels=kernels)
    tllama.verify_forward(params, torch.ones((S, 3), dtype=torch.int64), lens, engine.cache_k, engine.cache_v, cfg,
                          compute_dtype=cd, kernels=kernels)
    tllama.draft_propose(params, tokens, lens, engine.cache_k, engine.cache_v, cfg, k_steps=2, draft_layers=1,
                         compute_dtype=cd, kernels=kernels)
    if not kernels:
        assert wrapper_calls == {k: 0 for k in wrapper_calls}
        return
    # prefill, decode and verify over L layers, the draft 2 steps over 1
    assert wrapper_calls["w4_matmul"] == 7 * (3 * L + 2)
    assert wrapper_calls["paged_decode_attention"] == L
    assert wrapper_calls["spec_tail_attention_fused"] == L + 2


def _stream(engine, prompt, n, slot=0):
    tok, _ = engine.admit(slot, prompt)
    toks, cache_len, S = [tok], len(prompt), engine.num_slots
    while len(toks) < n:
        tokens = np.zeros((S,), np.int32)
        lens = np.zeros((S,), np.int32)
        tokens[slot], lens[slot] = toks[-1], cache_len
        if engine.spec_k:
            g, m = engine.spec_step(tokens, lens)
            new = [int(x) for x in g[slot, : int(m[slot]) + 1]]
        else:
            nxt, _ = engine.decode_step(tokens, lens)
            new = [int(nxt[slot])]
        toks.extend(new)
        cache_len += len(new)
    return toks[:n]


@pytest.mark.parametrize("spec_k", [0, 2])
@pytest.mark.parametrize("weight_format", ["fp32", "w4"])
def test_auto_and_xla_streams_equal_the_jax_engine(tiny_cfg, cfg, weight_format, spec_k):
    params = _np_params(cfg)
    prompts = [list(np.random.default_rng(s).integers(0, cfg.vocab_size, n)) for s, n in ((1, 5), (2, 13))]
    kw = dict(weight_format=weight_format, spec_k=spec_k, **GEOMETRY)
    jeng = JServeEngine(tiny_cfg, params, compute_dtype=jnp.float32, decode_kernel="xla", **kw)
    want = [_stream(jeng, p, 30) for p in prompts]  # 30 tokens wrap the 24-row ring
    for kernel in ("auto", "xla"):
        eng = ServeEngine(cfg, params, compute_dtype=torch.float32, device="cpu", decode_kernel=kernel, **kw)
        assert eng.decode_kernel == "xla"
        assert [_stream(eng, p, 30) for p in prompts] == want


def test_obs_label_follows_the_resolved_path(monkeypatch, tmp_path, cfg):
    monkeypatch.setenv("ODTP_OBS", "1")
    monkeypatch.setenv("ODTP_OBS_DIR", str(tmp_path))
    obs.reset()
    try:
        eng = ServeEngine(cfg, _np_params(cfg), compute_dtype=torch.float32, device="cpu", decode_kernel="xla",
                          **GEOMETRY)
        _stream(eng, [1, 2, 3], 4)
        probe = eng.kernel_probe(iters=1)
        tr = obs.tracer()
        counters, gauges = tr.counters(), tr.gauges()
        assert counters.get(("serve_decode_kernel_xla", ())) == 3
        assert ("serve_decode_kernel_pallas", ()) not in counters
        assert gauges[("serve_decode_kernel_pallas", ())] == 0.0
        assert set(probe) == {"decode_attn_us", "verify_attn_us"}
    finally:
        monkeypatch.delenv("ODTP_OBS")
        monkeypatch.delenv("ODTP_OBS_DIR")
        obs.reset()
