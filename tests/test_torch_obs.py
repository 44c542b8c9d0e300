"""The port's obs plane: tracer, exporters, Prometheus, MFU, and its hooks
on the serving and training planes, against the JAX package.

The cases of ``tests/test_obs.py`` on the port's copies (span API, zero
cost when ``ODTP_OBS`` is unset, the Chrome and Prometheus exporters, a
4-worker loopback round's merged trace, the logger satellites), then:

- each copied module's text is the reference's with the package name
  changed; ``mfu.py`` is the one that differs (no TPU roofline, no TPU
  peak), and its analytic FLOPs equal the JAX module's ``analytic_6n``;
- the batcher (plain, spec, prefix, tier) driven by hand in both packages
  on the same numpy weights and prompts, both planes armed in one
  process: the same exact counters, the same gauge names, the same
  request-trace stage chain per request, the same Prometheus families;
- two loopback workers of ``train()`` in both packages: the same
  ``inner_steps``, ``inner_tokens``, ``outer_rounds`` and per-codec wire
  bytes; ``inner_loss``, ``inner_grad_norm`` and ``pseudo_grad_norm``
  within atol 1e-5 / rtol 1e-5, the f32 tolerance of
  ``tests/test_torch_train.py`` (the two packages' f32 sums associate
  differently); the port's JSONL loads through the JAX
  ``obs.export.load_jsonl``;
- unarmed, the planes run without a tracer, a ring or a bound port, and
  their hook sites allocate nothing.
"""

import itertools
import json
import os
import pickle
import re
import threading
import tracemalloc

import numpy as np
import pytest
import torch

from opendiloco_torch import obs
from opendiloco_torch.diloco.loopback import LoopbackWorld
from opendiloco_torch.obs import export, mfu
from opendiloco_torch.utils.logger import (
    DummyLogger,
    JsonlLogger,
    get_logger,
    normalize_row,
    read_jsonl,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the env knobs of the obs plane (both packages read the same names)
OBS_ENV = ("ODTP_OBS", "ODTP_OBS_DIR", "ODTP_OBS_PROM_PORT", "ODTP_OBS_EVENTS_CAP", "ODTP_OBS_BLACKBOX_CAP",
           "ODTP_OBS_BLACKBOX_FLUSH_S", "ODTP_REQTRACE_CAP", "ODTP_REQTRACE_SAMPLE", "ODTP_REQTRACE_EXPORT",
           "ODTP_WATCHDOG_STALL_S", "ODTP_WATCHDOG_STRAGGLER_X", "ODTP_WATCHDOG_DIVERGE_Z", "ODTP_ROOFLINE")


def _reset_both():
    from opendiloco_tpu import obs as jobs

    obs.reset()
    jobs.reset()


@pytest.fixture(autouse=True)
def _clean_obs(monkeypatch):
    """Every test starts and ends with both packages' obs planes disarmed."""
    for var in OBS_ENV:
        monkeypatch.delenv(var, raising=False)
    _reset_both()
    yield
    _reset_both()


def _arm(monkeypatch, **extra):
    monkeypatch.setenv("ODTP_OBS", "test")
    for k, v in extra.items():
        monkeypatch.setenv(k, str(v))
    return obs.tracer()


# -- span API -----------------------------------------------------------------


def test_span_nesting_records_parent(monkeypatch):
    tr = _arm(monkeypatch)
    with tr.span("outer/step", epoch=1):
        with tr.span("outer/encode"):
            pass
    names = {e["name"]: e for e in tr.events}
    assert names["outer/encode"]["args"]["parent"] == "outer/step"
    assert "parent" not in names["outer/step"]["args"]
    assert names["outer/step"]["args"]["epoch"] == 1
    # spans are ph=X with microsecond ts/dur
    assert all(e["ph"] == "X" and e["dur"] >= 0.0 for e in tr.events)


def test_add_span_and_instant(monkeypatch):
    tr = _arm(monkeypatch)
    t0 = tr.now()
    t1 = tr.now()
    tr.add_span("outer/rendezvous", t0, t1, round="grads-epoch-0", group=4)
    tr.instant("outer/round", round="grads-epoch-0", group_size=4)
    kinds = sorted(e["ph"] for e in tr.events)
    assert kinds == ["X", "i"]
    assert tr.events[0]["args"]["group"] == 4


def test_thread_safety(monkeypatch):
    tr = _arm(monkeypatch)
    n_threads, n_iter = 8, 200

    def work(i):
        for k in range(n_iter):
            with tr.span(f"t{i}/span", k=k):
                tr.count("ops", worker=i)
            tr.gauge("depth", k, worker=i)

    threads = [
        threading.Thread(target=work, args=(i,)) for i in range(n_threads)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    # one "X" span event + one "C" counter-track event per gauge() call
    assert len(tr.events) == 2 * n_threads * n_iter
    counters = tr.counters()
    for i in range(n_threads):
        assert counters[("ops", (("worker", i),))] == n_iter


def test_events_cap_drops_not_grows(monkeypatch):
    tr = _arm(monkeypatch, ODTP_OBS_EVENTS_CAP=10)
    for i in range(25):
        tr.instant("tick", i=i)
    assert len(tr.events) == 10
    assert tr.dropped == 15


def test_stage_times_accumulates_across_threads():
    st = obs.StageTimes()
    fn = st.timed("encode", lambda x: x + 1)
    threads = [
        threading.Thread(target=lambda: [fn(1) for _ in range(50)])
        for _ in range(4)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert st.totals["encode"] > 0.0


# -- zero-cost when disabled --------------------------------------------------


def test_disabled_tracer_is_none_and_span_is_singleton():
    assert obs.tracer() is None
    assert not obs.enabled()
    assert obs.span("x") is obs.span("y")  # the inert singleton
    with obs.span("anything", k=1):
        pass  # no-op
    obs.count("n")
    obs.gauge("g", 1.0)
    assert obs.tracer() is None


def test_disabled_paths_do_not_allocate():
    # warm every code path first so imports/caches don't count
    for _ in range(10):
        with obs.span("warm"):
            pass
        obs.count("warm")
    tracemalloc.start()
    before = tracemalloc.take_snapshot()
    for _ in range(1000):
        with obs.span("hot/loop", k=1):
            pass
        obs.count("hot", n=2)
        obs.gauge("hot_g", 3.0)
    after = tracemalloc.take_snapshot()
    tracemalloc.stop()
    grown = sum(
        d.size_diff for d in after.compare_to(before, "filename")
        if d.size_diff > 0
    )
    # transient frames aside, the disabled plane must retain ~nothing
    assert grown < 16 * 1024


def test_no_prom_port_bound_when_disabled(monkeypatch):
    # PROM_PORT alone must not arm anything: no tracer, no socket
    monkeypatch.setenv("ODTP_OBS_PROM_PORT", "0")
    obs.reset()
    assert obs.tracer() is None


# -- exporters ----------------------------------------------------------------


def test_chrome_trace_valid_and_merges_clocks(monkeypatch, tmp_path):
    tr = _arm(monkeypatch, ODTP_OBS_DIR=str(tmp_path))
    tr.set_identity(worker=0)
    with tr.span("outer/step", epoch=0):
        pass
    p0 = tr.flush()
    assert p0 and os.path.exists(p0)
    events, meta = export.load_jsonl(p0)
    assert meta["origin_wall"] > 0
    # fake a second worker whose clock started 1s later
    meta2 = dict(meta, origin_wall=meta["origin_wall"] + 1.0)
    trace = export.chrome_trace([(0, events, meta), (1, events, meta2)])
    doc = json.loads(json.dumps(trace))  # must be pure-JSON serializable
    assert isinstance(doc["traceEvents"], list)
    names = [e["name"] for e in doc["traceEvents"]]
    assert names.count("process_name") == 2
    spans = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert {e["pid"] for e in spans} == {0, 1}
    w0 = next(e for e in spans if e["pid"] == 0)
    w1 = next(e for e in spans if e["pid"] == 1)
    assert w1["ts"] - w0["ts"] == pytest.approx(1e6, rel=1e-3)
    for e in spans:
        assert set(e) >= {"name", "ph", "ts", "dur", "pid", "tid", "args"}


_PROM_LINE = re.compile(
    r"^(# (HELP|TYPE) [a-zA-Z_:][a-zA-Z0-9_:]* .+"
    r"|[a-zA-Z_:][a-zA-Z0-9_:]*(\{[a-zA-Z0-9_]+=\"([^\"\\]|\\.)*\""
    r"(,[a-zA-Z0-9_]+=\"([^\"\\]|\\.)*\")*\})? -?[0-9.e+-]+(e[+-][0-9]+)?)$"
)


def test_prometheus_text_lints(monkeypatch):
    tr = _arm(monkeypatch)
    tr.count("outer_rounds")
    tr.count("rdv_rpcs", msg="join")
    tr.gauge("outer_group_size", 8)
    tr.gauge("weird name!", 1.5, label_x='quo"te')
    text = export.prometheus_text(tr)
    assert text.endswith("\n")
    for line in text.rstrip("\n").splitlines():
        assert _PROM_LINE.match(line), f"unlintable line: {line!r}"
    assert "odtp_outer_rounds" in text
    assert 'msg="join"' in text
    assert "odtp_obs_events_total" in text
    # disabled plane renders empty (the control-port frame returns no body)
    assert export.prometheus_text(None) == ""


def test_prom_endpoint_serves_over_http(monkeypatch):
    import urllib.request

    tr = _arm(monkeypatch, ODTP_OBS_PROM_PORT=0)
    assert tr.prom is not None and tr.prom.port > 0
    tr.count("outer_rounds", 3)
    body = urllib.request.urlopen(
        f"http://127.0.0.1:{tr.prom.port}/metrics", timeout=5
    ).read().decode()
    assert "odtp_outer_rounds 3.0" in body


# -- end-to-end: 4-worker loopback round --------------------------------------


def test_loopback_round_merged_trace_has_every_stage(monkeypatch, tmp_path):
    tr = _arm(monkeypatch, ODTP_OBS_DIR=str(tmp_path))
    world = LoopbackWorld(4)
    backends = world.make_backends()
    data = [np.ones((8,), np.float32)]
    results = {}

    def run(b):
        out, n = b.all_reduce(data, timeout=30.0, tag="grads", epoch=0)
        results[b.peer_id] = (out, n)

    threads = [threading.Thread(target=run, args=(b,)) for b in backends]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert all(n == 4 for _, n in results.values())

    by_worker: dict[str, set] = {}
    for e in tr.events:
        w = e["args"].get("worker")
        if w is not None:
            by_worker.setdefault(w, set()).add(e["name"])
    assert set(by_worker) == {b.peer_id for b in backends}
    for w, names in by_worker.items():
        assert {"outer/encode", "outer/reduce_wait", "outer/adopt",
                "outer/round"} <= names, f"{w} missing stages: {names}"
    # every worker's round record merges on the same round id
    rounds = {
        e["args"]["round"] for e in tr.events if e["name"] == "outer/round"
    }
    assert rounds == {"grads-epoch-0"}
    # and the single-process Chrome view of it is well-formed
    doc = export.tracer_chrome_trace(tr)
    assert any(e["ph"] == "i" for e in doc["traceEvents"])


# -- logger satellites --------------------------------------------------------


def test_normalize_row_coerces_and_flattens():
    row = normalize_row({
        "Loss": np.float32(1.5),
        "step": 3,
        "flag": True,
        "nested": {"a": np.int64(2), "b": {"c": 1.0}},
        "arr0d": np.array(2.5),
        "weird": object(),
    })
    assert row["Loss"] == 1.5 and isinstance(row["Loss"], float)
    assert row["step"] == 3 and isinstance(row["step"], int)
    assert row["flag"] is True
    assert row["nested/a"] == 2.0
    assert row["nested/b/c"] == 1.0
    assert row["arr0d"] == 2.5
    assert isinstance(row["weird"], str)
    json.dumps(row)  # the whole row must be JSON-typed


def test_jsonl_logger_roundtrip(tmp_path):
    path = str(tmp_path / "rows.jsonl")
    lg = get_logger("jsonl", path, config={})
    assert isinstance(lg, JsonlLogger)
    lg.log({"Loss": np.float32(2.0), "step": 1})
    lg.log({"Loss": 1.0, "step": 2})
    lg.finish()
    # a trailing partial line (killed writer) is skipped, not fatal
    with open(path, "a") as f:
        f.write('{"Loss": 0.5, "st')
    rows = read_jsonl(path)
    assert [r["step"] for r in rows] == [1, 2]
    assert rows[0]["Loss"] == 2.0


def test_dummy_logger_finish_is_atomic(tmp_path, monkeypatch):
    path = str(tmp_path / "spy.pkl")
    lg = DummyLogger(path, config={})
    lg.log({"Loss": np.float32(1.0)})
    # a crash mid-finish must never truncate an existing artifact: finish
    # writes a tmp file then os.replace()s it into place
    replaced = {}
    real_replace = os.replace

    def spy_replace(src, dst):
        replaced["src"], replaced["dst"] = src, dst
        return real_replace(src, dst)

    monkeypatch.setattr(os, "replace", spy_replace)
    lg.finish()
    assert replaced["dst"] == path
    assert replaced["src"].startswith(path + ".tmp.")
    with open(path, "rb") as f:
        assert pickle.load(f) == [{"Loss": 1.0}]
    assert not os.path.exists(replaced["src"])


def test_unknown_logger_type_rejected():
    with pytest.raises(ValueError):
        get_logger("nosuch", "/tmp/x", config={})


# -- the copies ---------------------------------------------------------------

COPIED = ("__init__", "trace", "export", "prom", "reqtrace", "overseer", "anomaly", "blackbox")


@pytest.mark.parametrize("name", COPIED)
def test_copied_module_text_equals_the_reference(name):
    """Each host-only obs module is the JAX package's text with the package
    name changed, so a fix on either side shows here."""
    with open(os.path.join(REPO, "opendiloco_tpu", "obs", f"{name}.py")) as f:
        want = f.read().replace("opendiloco_tpu", "opendiloco_torch")
    with open(os.path.join(REPO, "opendiloco_torch", "obs", f"{name}.py")) as f:
        assert f.read() == want


def test_mfu_is_the_one_module_that_differs_and_reads_no_tpu_number():
    """``mfu.py`` is not a copy: it reads no roofline file and holds no TPU
    peak; nothing in the port reads ``AOT_ROOFLINE.json``."""
    names = sorted(f[:-3] for f in os.listdir(os.path.join(REPO, "opendiloco_tpu", "obs")) if f.endswith(".py"))
    assert sorted(set(names) - set(COPIED)) == ["mfu"]
    with open(os.path.join(REPO, "opendiloco_torch", "obs", "mfu.py")) as f:
        text = f.read()
    assert "1.97e14" not in text and "import json" not in text and "open(" not in text
    for root, _, files in os.walk(os.path.join(REPO, "opendiloco_torch")):
        for fn in files:
            if fn.endswith(".py"):
                with open(os.path.join(root, fn)) as f:
                    assert "AOT_ROOFLINE" not in f.read(), fn


@pytest.mark.parametrize("model", ["2m", "150m", "1b"])
def test_mfu_flops_per_token_is_the_jax_analytic_path(monkeypatch, tmp_path, model):
    """FLOPs per token from the model's shapes equal the JAX module's
    ``analytic_6n`` (its roofline file pointed nowhere) on the same
    parameter count; the H100's peak is the datasheet's dense bf16 one;
    the CPU and a card not in the table have no peak and no FLOPs."""
    from opendiloco_tpu.obs import mfu as jmfu
    from opendiloco_torch.models import hf_io, llama

    monkeypatch.setenv("ODTP_ROOFLINE", str(tmp_path / "nowhere.json"))
    cfg = hf_io.load_config(model)
    n = llama.num_params(cfg)
    jflops, _, jsource = jmfu.flops_per_token(model, n)
    assert jsource == "analytic_6n"
    flops, peak, source = mfu.flops_per_token(model, n, "NVIDIA H100 80GB HBM3")
    assert (flops, source) == (jflops, "analytic_6n")
    assert peak == 989e12
    assert mfu.flops_per_token(model, n, "cpu") == (None, None, "unavailable")
    assert mfu.flops_per_token(model, n, "NVIDIA A100-SXM4-80GB") == (None, None, "unavailable")
    u = mfu.mfu(1e5, flops, n_devices=1, peak_flops_per_device=peak)
    assert u == pytest.approx(flops * 1e5 / 989e12)


# -- the serving plane against the JAX batcher ---------------------------------

# name: (ServeEngine kwargs, batcher kwargs, tier host slots or None,
# prompts: (count, length, shared prefix length), max_new_tokens)
SERVE_CASES = {
    "plain": ({"num_slots": 4}, {}, None, (6, 12, 0), 10),
    "spec": ({"num_slots": 4, "spec_k": 2}, {}, None, (4, 12, 0), 11),
    "prefix": ({"num_slots": 4}, {"prefix_cache": True}, None, (4, 14, 10), 6),
    "tier": ({"num_slots": 2}, {"prefix_cache": True, "tier_quantum_steps": 1, "tier_min_resident_steps": 1}, 8,
             (5, 12, 0), 24),
}
# the counters that a run's decisions fix exactly, in both packages
EXACT_COUNTERS = ("serve_tokens_generated", "serve_requests_completed", "serve_prefix_hits",
                  "serve_prefix_tokens_saved", "serve_host_prefix_hits", "serve_spec_proposed", "serve_spec_accepted",
                  "serve_tier_evictions", "serve_tier_resumes", "serve_page_out_bytes", "serve_page_in_bytes",
                  "serve_decode_kernel_xla")


def _serve_prompts(vocab, n, length, shared, seed=5):
    rng = np.random.default_rng(seed)
    head = rng.integers(1, vocab, shared).tolist()
    return [head + rng.integers(1, vocab, length - shared).tolist() for _ in range(n)]


def _drive(batcher, reqs, limit=2000):
    """The batcher loop's body by hand, until every request is done: both
    packages take the same decisions on the same state."""
    for _ in range(limit):
        if all(r.wait(0) for r in reqs):
            return
        batcher._sweep_cancelled()
        batcher._finish_pageouts()
        batcher._admit()
        batcher._decode()
    raise AssertionError("requests did not finish")


def _families(text: str) -> set:
    return {line.split()[2] for line in text.splitlines() if line.startswith("# TYPE ")}


def _run_serve_case(case, tiny_cfg):
    from opendiloco_tpu import obs as jobs
    from opendiloco_tpu.obs import reqtrace as jreqtrace
    from opendiloco_tpu.serve.engine import ServeEngine as JServeEngine
    from opendiloco_tpu.serve.kvcache import HostKVTier as JHostKVTier
    from opendiloco_tpu.serve.scheduler import ContinuousBatcher as JBatcher
    from opendiloco_torch.models import llama as tllama
    from opendiloco_torch.obs import reqtrace
    from opendiloco_torch.serve import ContinuousBatcher, HostKVTier, ServeEngine
    from test_torch_serve_engine import _np_params

    engine_kw, batcher_kw, host_slots, (n, length, shared), max_new = SERVE_CASES[case]
    cfg = tllama.LlamaConfig.from_dict(tiny_cfg.to_dict())
    params = _np_params(cfg, seed=3)
    geom = dict(max_context=64, prefill_buckets=(8, 16, 32), **engine_kw)
    port = ContinuousBatcher(ServeEngine(cfg, params, compute_dtype=torch.float32, device="cpu", **geom),
                             kv_tier=HostKVTier(host_slots=host_slots) if host_slots else None, **batcher_kw)
    ref = JBatcher(JServeEngine(tiny_cfg, params, compute_dtype=np.float32, decode_kernel="xla", **geom),
                   kv_tier=JHostKVTier(host_slots=host_slots) if host_slots else None, **batcher_kw)
    prompts = _serve_prompts(cfg.vocab_size, n, length, shared)
    out = {}
    for side, b in (("port", port), ("jax", ref)):
        reqs = [b.submit(p, max_new_tokens=max_new, trace={"id": f"{case}-{i}", "o": "test"})
                for i, p in enumerate(prompts)]
        _drive(b, reqs)
        b._publish_gauges()
        out[side] = [list(r.tokens) for r in reqs]
    return out, (obs.tracer(), reqtrace.ring()), (jobs.tracer(), jreqtrace.ring()), len(prompts)


@pytest.mark.parametrize("case", list(SERVE_CASES))
def test_batcher_reports_what_the_jax_batcher_reports(monkeypatch, tiny_cfg, case):
    """Both packages' batchers on the same numpy weights and prompts, driven
    by hand, both planes armed: the same tokens, the same exact counters
    (kernel label "xla": the plain path runs on the CPU), the same gauge
    names, the same request-trace stage chain per request, the same
    Prometheus families."""
    from opendiloco_tpu.obs import export as jexport

    _arm(monkeypatch)
    tokens, (tr, rt), (jtr, jrt), n = _run_serve_case(case, tiny_cfg)
    assert tokens["port"] == tokens["jax"]
    got, want = tr.counters(), jtr.counters()
    for name in EXACT_COUNTERS:
        assert got.get((name, ())) == want.get((name, ())), name
    assert sorted(got) == sorted(want)
    assert sorted(tr.gauges()) == sorted(jtr.gauges())
    for i in range(n):
        mine, theirs = rt.get(f"{case}-{i}"), jrt.get(f"{case}-{i}")
        assert mine["status"] == theirs["status"] == "done"
        assert [s["stage"] for s in mine["spans"]] == [s["stage"] for s in theirs["spans"]]
        assert mine["spans"][0]["stage"] == "queue" and mine["spans"][-1]["stage"] == "retire"
    families = _families(export.prometheus_text(tr))
    assert families == _families(jexport.prometheus_text(jtr))
    assert {"odtp_serve_tokens_generated", "odtp_serve_p99_ms", "odtp_serve_queue_depth"} <= families


# -- the training plane against the JAX package ---------------------------------

# a model directory with weights: both packages start from the same params
TRAIN = dict(path_model=os.path.join(REPO, "tests", "models", "llama-2m-fresh"), fake_data=True, fake_data_mode="ramp", seq_length=32, per_device_train_batch_size=4,
             total_batch_size=8, warmup_steps=2, lr=3e-3, metric_logger_type="dummy", precision="fp32")


def run_train_workers(n, *, steps, local_steps, tmp=None, jax_side=False, compression="none", **diloco):
    """``n`` loopback workers of ``train()`` in threads (the port's, or with
    ``jax_side`` the JAX package's, each JAX worker on a device of its own:
    concurrent multi-device executions deadlock on the CPU client); returns
    each worker's metric rows."""
    import tempfile

    tmp = str(tmp or tempfile.mkdtemp())
    os.makedirs(tmp, exist_ok=True)
    if jax_side:
        import jax

        from opendiloco_tpu import train as jtrain
        from opendiloco_tpu.config import Config as JConfig
        from opendiloco_tpu.diloco.loopback import LoopbackWorld as JLoopbackWorld
        from opendiloco_tpu.parallel import mesh as jmesh

        devices, lock = itertools.count(), threading.Lock()
        build = jmesh.build_mesh

        def one_device(strategy, **_kw):
            with lock:
                d = jax.devices()[next(devices) % len(jax.devices())]
            return build(strategy, devices=[d])

        world = JLoopbackWorld(n, compression=compression)
        run = lambda cfg, backend: jtrain.train(JConfig(**cfg), backend)
    else:
        from opendiloco_torch.config import Config
        from opendiloco_torch.train import train

        world = LoopbackWorld(n, compression=compression)
        run = lambda cfg, backend: train(Config(**cfg), backend, device="cpu")
    backends = world.make_backends()
    errors = []

    def worker(rank):
        try:
            run(dict(TRAIN, total_steps=steps, project=os.path.join(tmp, f"rows-{rank}.pkl"),
                     diloco=dict(local_steps=local_steps, backend="loopback", world_rank=rank,
                                 timeout_waiting_for_peers=30.0, **diloco)), backends[rank])
        except Exception as e:  # pragma: no cover
            errors.append(e)

    if jax_side:
        jtrain.build_mesh = one_device
    try:
        threads = [threading.Thread(target=worker, args=(r,)) for r in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        if jax_side:
            jtrain.build_mesh = build
    assert not errors, errors
    rows = []
    for rank in range(n):
        with open(os.path.join(tmp, f"rows-{rank}.pkl"), "rb") as f:
            rows.append(pickle.load(f))
    return rows


def _gauge_values(tr, name: str) -> list:
    return sorted(e["args"]["value"] for e in tr.events if e["ph"] == "C" and e["name"] == name)


@pytest.fixture(scope="module")
def train_runs(tmp_path_factory):
    """Two loopback workers, 4 steps, local_steps 2 (two outer rounds), fp16
    on the loopback wire, in both packages with both planes armed and the
    JSONL sink on: each package's tracer and the port's rows."""
    from opendiloco_tpu import obs as jobs

    tmp = tmp_path_factory.mktemp("obs_train")
    saved = {k: os.environ.get(k) for k in OBS_ENV}
    os.environ.update({"ODTP_OBS": "test", "ODTP_OBS_DIR": str(tmp / "obs")})
    os.environ.pop("ODTP_ROOFLINE", None)
    _reset_both()
    try:
        rows = run_train_workers(2, steps=4, local_steps=2, tmp=tmp, compression="fp16")
        run_train_workers(2, steps=4, local_steps=2, tmp=tmp / "jax", jax_side=True, compression="fp16")
        tr, jtr = obs.tracer(), jobs.tracer()
        path = tr.flush()
        yield {"tr": tr, "jtr": jtr, "rows": rows, "jsonl": path}
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        _reset_both()


def test_training_counters_equal_the_jax_package(train_runs):
    """inner_steps, inner_tokens, outer_rounds and the per-codec wire bytes
    of the two-worker run equal the JAX package's exactly."""
    got, want = train_runs["tr"].counters(), train_runs["jtr"].counters()
    for key in [("inner_steps", ()), ("inner_tokens", ()), ("outer_rounds", ()),
                ("outer_raw_bytes", (("codec", "fp16"),)), ("outer_wire_bytes", (("codec", "fp16"),))]:
        assert got[key] == want[key], key
    assert got[("inner_steps", ())] == 8 and got[("outer_rounds", ())] == 4
    assert sorted(got) == sorted(want)


@pytest.mark.parametrize("name", ["inner_loss", "inner_grad_norm", "pseudo_grad_norm"])
def test_training_gauge_series_match_the_jax_package(train_runs, name):
    """Every value each gauge took (both workers, every step or round)
    within the f32 tolerance of tests/test_torch_train.py."""
    got, want = _gauge_values(train_runs["tr"], name), _gauge_values(train_runs["jtr"], name)
    assert len(got) == len(want) > 0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_training_spans_gauges_and_prometheus_families(train_runs):
    """The port's run carries the JAX run's span names, gauge names and
    Prometheus families; every inner step has its dispatch span and every
    outer round its stages."""
    from opendiloco_tpu.obs import export as jexport

    tr, jtr = train_runs["tr"], train_runs["jtr"]
    spans = lambda t: sorted({e["name"] for e in t.events if e["ph"] in ("X", "i")})
    assert spans(tr) == spans(jtr)
    assert {"inner/dispatch", "outer/barrier_wait", "outer/d2h", "outer/allreduce", "outer/apply", "outer/step",
            "outer/encode", "outer/reduce_wait", "outer/adopt", "outer/round"} <= set(spans(tr))
    assert sum(e["name"] == "inner/dispatch" for e in tr.events) == 8
    assert sorted(k for k in tr.gauges() if k[0] != "inner_mfu") == sorted(
        k for k in jtr.gauges() if k[0] != "inner_mfu")
    # the JAX rows carry an mfu (a TPU peak on the CPU); the port's CPU rows none
    assert ("inner_mfu", ()) not in tr.gauges()
    assert all("mfu" not in r for rows in train_runs["rows"] for r in rows)
    fam = lambda t: {f for f in _families(export.prometheus_text(t)) if f != "odtp_inner_mfu"}
    assert fam(tr) == {f for f in _families(jexport.prometheus_text(jtr)) if f != "odtp_inner_mfu"}


def test_port_jsonl_loads_through_the_jax_exporter(train_runs):
    """The port's JSONL sink is the reference's format: the JAX
    ``load_jsonl`` reads it, with the run's counters in its meta record,
    and the reference's Chrome trace builds from it."""
    from opendiloco_tpu.obs import export as jexport

    events, meta = jexport.load_jsonl(train_runs["jsonl"])
    assert len(events) == len(train_runs["tr"].events)
    assert meta["counters"]["inner_steps"] == 8
    assert meta["identity"]["mfu_source"] == "unavailable"
    doc = jexport.chrome_trace([(0, events, meta)])
    assert any(e["name"] == "outer/step" for e in doc["traceEvents"])


# -- unarmed: the planes run at zero cost ---------------------------------------


def test_unarmed_planes_make_no_tracer_ring_or_port(monkeypatch, tmp_path, tiny_cfg):
    """With ``ODTP_OBS`` unset (a Prometheus port set alone arms nothing)
    a served request and a training run leave no tracer, no request-trace
    ring, no flight recorder, no watchdog and no overseer behind."""
    from opendiloco_torch.obs import anomaly, blackbox, overseer, reqtrace, trace

    monkeypatch.setenv("ODTP_OBS_PROM_PORT", "0")
    tokens, (tr, rt), _, _ = _run_serve_case("plain", tiny_cfg)
    assert tr is None and rt is None
    rows = run_train_workers(2, steps=2, local_steps=2, tmp=tmp_path)
    assert all(len(r) == 2 for r in rows)
    assert trace._tracer is None and reqtrace.ring() is None
    assert blackbox.recorder() is None and anomaly.watchdog() is None and overseer.plane() is None


def test_unarmed_hook_sites_do_not_allocate():
    """The hook sites' pattern on the planes' hot paths (a counter, a
    gauge, the tracer and ring lookups with their None branch) retains
    nothing unarmed."""
    from opendiloco_torch.obs import reqtrace

    def hooks():
        obs.count("serve_tokens_generated", 4)
        obs.count(f"serve_decode_kernel_{'xla'}")
        tr = obs.tracer()
        if tr is not None:
            raise AssertionError("armed?")
        if reqtrace.ring() is not None:
            raise AssertionError("armed?")
        if obs.anomaly.watchdog() is not None:
            raise AssertionError("armed?")

    for _ in range(10):
        hooks()
    tracemalloc.start()
    before = tracemalloc.take_snapshot()
    for _ in range(1000):
        hooks()
    after = tracemalloc.take_snapshot()
    tracemalloc.stop()
    grown = sum(d.size_diff for d in after.compare_to(before, "filename") if d.size_diff > 0)
    assert grown < 16 * 1024
