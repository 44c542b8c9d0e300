"""The port's request tracing: the reqtrace ring and the serving plane's
stage chains.

The cases of ``tests/test_reqtrace.py`` on the port's copy
(``opendiloco_torch/obs/reqtrace.py``) and on the port's batcher and
server: zero cost unarmed, mint, span, finish and report, sampling, the
bounded rings, adopt, the wire context, exemplars, the dump, the SLO
watchdog's exemplars; then a served request's complete stage chain
(queue, prefill, decode, retire) through the batcher, the HTTP edge
(minted there) and the JSONL edge (adopted from the client), token-exact
spec decode spans, the reject and 503 paths' shed traces, the health
row's exemplars; the autoscaler's scale-up exemplars and SLO watchdog,
and the router's trace context (untraced payloads stay clean, mint,
adopt, one trace across a replica's death, shed, all replicas dead,
sampled out) over the reference suite's fake replicas, with the
reference's assertions. Last, the JAX router in front of a port replica,
both armed: the JAX router's trace id reaches the port replica, whose
ring answers the ``reqtrace`` frame with that request's stage chain.
"""
import json
import socket
import time
import urllib.request

import pytest
import torch

from opendiloco_torch import obs
from opendiloco_torch.diloco.schema import TRACE_CTX_KEY
from opendiloco_torch.fleet.autoscaler import FleetAutoscaler
from opendiloco_torch.fleet.router import FleetRouter
from opendiloco_torch.obs import reqtrace
from test_reqtrace import _FakeReplica, _ScalerManager, _ScalerRouter


@pytest.fixture(autouse=True)
def _clean_obs(monkeypatch):
    """Every test starts and ends with the obs plane disarmed."""
    for var in ("ODTP_OBS", "ODTP_OBS_DIR", "ODTP_REQTRACE_CAP",
                "ODTP_REQTRACE_SAMPLE", "ODTP_REQTRACE_EXPORT"):
        monkeypatch.delenv(var, raising=False)
    obs.reset()
    yield
    obs.reset()


def _arm(monkeypatch, **extra):
    monkeypatch.setenv("ODTP_OBS", "test")
    for k, v in extra.items():
        monkeypatch.setenv(k, str(v))
    return reqtrace.ring()


# -- ring unit tests (jax-free) ----------------------------------------------


def test_zero_cost_when_unarmed():
    assert reqtrace.ring() is None
    # helpers stay usable without a ring (hook sites never crash)
    assert reqtrace.ctx_of({"prompt": [1]}) is None
    payload = {"prompt": [1]}
    assert reqtrace.attach(payload, None) is payload


def test_mint_span_finish_report(monkeypatch):
    rt = _arm(monkeypatch)
    rt.set_identity("r0")
    ctx = rt.mint(at="router")
    assert ctx is not None and ctx["id"].startswith("r0-")
    tid = ctx["id"]
    t0 = time.perf_counter()
    rt.span(tid, "queue", t0, t0 + 0.010)
    rt.span(tid, "prefill", t0 + 0.010, t0 + 0.030, tokens=8, bucket=8)
    rt.span(tid, "decode", t0 + 0.030, t0 + 0.050, batch=1, tokens=1)
    rt.span(tid, "decode", t0 + 0.050, t0 + 0.070, batch=1, tokens=1)
    rt.event(tid, "retire")
    rt.finish(tid, "done", tokens=3)
    tr = rt.get(tid)
    assert tr["status"] == "done"
    assert [s["stage"] for s in tr["spans"]] == [
        "queue", "prefill", "decode", "decode", "retire",
    ]
    # stage seconds accrue exactly (decode aggregates both rounds)
    assert tr["stages_s"]["decode"] == pytest.approx(0.040, abs=5e-3)
    rep = rt.report()
    assert rep["completed"] == 1 and rep["statuses"] == {"done": 1}
    assert set(rep["stages"]) == {"queue", "prefill", "decode", "retire"}
    assert rep["stages"]["decode"]["count"] == 1  # per-request totals
    assert rep["dominant_stage_p99"] == "decode"
    assert rep["e2e_ms"]["count"] == 1


def test_sampling_is_deterministic_thinning(monkeypatch):
    rt = _arm(monkeypatch, ODTP_REQTRACE_SAMPLE="0.5")
    minted = [rt.mint() for _ in range(10)]
    assert sum(1 for c in minted if c is not None) == 5
    # sample=0 never mints
    obs.reset()
    monkeypatch.setenv("ODTP_REQTRACE_SAMPLE", "0")
    rt = reqtrace.ring()
    assert all(rt.mint() is None for _ in range(5))


def test_completed_ring_is_bounded(monkeypatch):
    rt = _arm(monkeypatch, ODTP_REQTRACE_CAP="4")
    for _ in range(6):
        ctx = rt.mint()
        rt.finish(ctx["id"])
    assert len(rt.completed) == 4 and rt.evicted == 2
    assert rt.report()["evicted"] == 2


def test_span_list_caps_but_stage_seconds_accrue(monkeypatch):
    rt = _arm(monkeypatch)
    tid = rt.mint()["id"]
    t0 = time.perf_counter()
    n = reqtrace.MAX_SPANS_PER_TRACE + 10
    for i in range(n):
        rt.span(tid, "decode", t0, t0 + 0.001, batch=1)
    tr = rt.get(tid)
    assert len(tr["spans"]) == reqtrace.MAX_SPANS_PER_TRACE
    assert tr["spans_dropped"] == 10
    assert tr["stages_s"]["decode"] == pytest.approx(n * 0.001, rel=1e-6)


def test_adopt_is_idempotent_and_preserves_origin(monkeypatch):
    rt = _arm(monkeypatch)
    ctx = {"id": "client-1", "o": "edge"}
    assert rt.adopt(ctx, priority=2) == "client-1"
    assert rt.adopt(ctx) == "client-1"  # second hop, same process
    assert rt.adopted == 1
    tr = rt.get("client-1")
    assert tr["origin"] == "edge" and tr["attrs"]["priority"] == 2
    assert rt.adopt(None) is None
    assert rt.adopt({"no": "id"}) is None


def test_attach_and_ctx_of_roundtrip():
    ctx = {"id": "t-1", "o": "router"}
    payload = reqtrace.attach({"prompt": [1, 2]}, ctx)
    assert payload[TRACE_CTX_KEY] == {"id": "t-1", "o": "router"}
    assert reqtrace.ctx_of(payload) == {"id": "t-1", "o": "router"}
    # malformed contexts are ignored, not fatal (old/buggy peers)
    assert reqtrace.ctx_of({TRACE_CTX_KEY: "t-1"}) is None
    assert reqtrace.ctx_of({TRACE_CTX_KEY: {"id": 7}}) is None


def test_exemplars_are_slowest_first(monkeypatch):
    rt = _arm(monkeypatch)
    t0 = time.perf_counter()
    for ms in (5, 50, 20):
        tid = rt.mint()["id"]
        rt.span(tid, "decode", t0, t0 + ms / 1e3)
        # e2e is wall-measured; make it track the span size
        rt.inflight[tid]["t0"] = time.perf_counter() - ms / 1e3
        rt.finish(tid)
    ex = rt.exemplars(2)
    assert len(ex) == 2
    assert ex[0]["e2e_ms"] > ex[1]["e2e_ms"]


def test_dump_and_atexit_export(monkeypatch, tmp_path):
    path = tmp_path / "reqtrace.json"
    rt = _arm(monkeypatch, ODTP_REQTRACE_EXPORT=str(path))
    tid = rt.mint()["id"]
    rt.event(tid, "retire")
    rt.finish(tid)
    assert rt.dump(reason="test") == str(path)
    body = json.loads(path.read_text())
    assert body["report"]["completed"] == 1
    assert body["traces"][0]["id"] == tid


# -- watchdog + autoscaler evidence -------------------------------------------


def test_slo_breach_watchdog_carries_exemplars(monkeypatch):
    _arm(monkeypatch)
    wd = obs.anomaly.watchdog()
    assert wd.slo_breach(80.0, 100.0) is False  # under the bound
    assert wd.slo_breach(120.0, 100.0, subject="r1",
                         exemplars=["t-1", "t-2"]) is True
    bb = obs.blackbox.recorder()
    rec = [a for a in bb.anomalies if a["kind"] == "slo_breach"]
    assert rec and rec[0]["exemplars"] == ["t-1", "t-2"]
    assert rec[0]["subject"] == "r1"


def test_scale_up_decision_carries_breach_exemplars(monkeypatch):
    """Every scale-up names at least one exemplar trace id from the
    breaching replica's health row."""
    _arm(monkeypatch)
    router = _ScalerRouter()
    manager = _ScalerManager(router)
    router.add_replica("r0", "127.0.0.1", 9000)
    manager.health["r0"] = {
        "p99_ms": 500.0, "queue_depth": 0,
        "slo_exemplars": ["r0-aa-1", "r0-aa-2"],
    }
    booted = []
    scaler = FleetAutoscaler(
        manager, router, slo_p99_ms=100.0, min_replicas=1, max_replicas=4,
        cooldown_s=0.0, up_evals=1,
        boot_fn=lambda rid, reg: booted.append(rid) or router.add_replica(
            rid, "127.0.0.1", 9001
        ),
    )
    decisions = scaler.evaluate()
    ups = [d for d in decisions if d["action"] == "scale_up"]
    assert ups and ups[0]["exemplars"][:2] == ["r0-aa-1", "r0-aa-2"]
    # the breach also tripped the slo_breach watchdog with the evidence
    bb = obs.blackbox.recorder()
    trips = [a for a in bb.anomalies if a["kind"] == "slo_breach"]
    assert trips and trips[0]["subject"] == "r0"
    assert trips[0]["exemplars"][:2] == ["r0-aa-1", "r0-aa-2"]


def test_scale_up_exemplars_fall_back_to_local_ring(monkeypatch):
    """Rows without slo_exemplars fall back to this process's own ring
    (in-process fleets share one)."""
    rt = _arm(monkeypatch)
    tid = rt.mint()["id"]
    rt.finish(tid)
    router = _ScalerRouter()
    manager = _ScalerManager(router)
    router.add_replica("r0", "127.0.0.1", 9000)
    manager.health["r0"] = {"p99_ms": 500.0, "queue_depth": 0}
    scaler = FleetAutoscaler(
        manager, router, slo_p99_ms=100.0, max_replicas=4,
        cooldown_s=0.0, up_evals=1,
        boot_fn=lambda rid, reg: router.add_replica(rid, "127.0.0.1", 9001),
    )
    ups = [d for d in scaler.evaluate() if d["action"] == "scale_up"]
    assert ups and ups[0]["exemplars"] == [tid]


# -- router propagation over the reference's fake replicas --------------------


def test_router_untraced_payloads_stay_clean():
    """Obs disarmed: no trace field ever reaches the replica."""
    a = _FakeReplica("a")
    router = FleetRouter(port=0, probe_interval_s=30.0, request_timeout=5.0)
    try:
        router.add_replica("a", "127.0.0.1", a.port)
        out = router.dispatch({"prompt": [1, 2], "max_new_tokens": 2})
        assert out["tokens"] == [1, 2, 3]
        assert TRACE_CTX_KEY not in a.payloads[0]
    finally:
        router.stop()
        a.kill()


def test_router_mints_context_that_rides_the_wire(monkeypatch):
    rt = _arm(monkeypatch)
    rt.set_identity("router")
    a = _FakeReplica("a")
    router = FleetRouter(port=0, probe_interval_s=30.0, request_timeout=5.0)
    try:
        router.add_replica("a", "127.0.0.1", a.port)
        out = router.dispatch({"prompt": [1, 2, 3], "max_new_tokens": 2,
                               "id": 7})
        assert out["tokens"] == [1, 2, 3]
        wire_ctx = a.payloads[0][TRACE_CTX_KEY]
        tr = rt.get(wire_ctx["id"])
        assert tr["status"] == "done"
        stages = [s["stage"] for s in tr["spans"]]
        assert stages == ["admit", "forward"]
        assert tr["spans"][1]["attrs"]["replica"] == "a"
        assert tr["attrs"]["redispatches"] == 0
        assert rt.inflight_ids() == []
    finally:
        router.stop()
        a.kill()


def test_router_adopts_upstream_context(monkeypatch):
    rt = _arm(monkeypatch)
    a = _FakeReplica("a")
    router = FleetRouter(port=0, probe_interval_s=30.0, request_timeout=5.0)
    try:
        router.add_replica("a", "127.0.0.1", a.port)
        out = router.dispatch({
            "prompt": [1], "max_new_tokens": 1,
            TRACE_CTX_KEY: {"id": "client-9", "o": "client"},
        })
        assert out["tokens"] == [1, 2, 3]
        # the same id downstream: no re-mint
        assert a.payloads[0][TRACE_CTX_KEY]["id"] == "client-9"
        assert rt.get("client-9")["status"] == "done"
        assert rt.adopted == 1 and rt.minted == 0
    finally:
        router.stop()
        a.kill()


def test_replica_death_yields_one_trace_spanning_both_replicas(monkeypatch):
    """The redispatch after a replica's death keeps the request's
    history: one trace holds the dead replica's forward, the redispatch
    marker and the survivor's answer, and nothing is left inflight."""
    rt = _arm(monkeypatch)
    a = _FakeReplica("a", die_on_request=True)
    b = _FakeReplica("b")
    router = FleetRouter(port=0, probe_interval_s=30.0, request_timeout=10.0)
    try:
        router.add_replica("a", "127.0.0.1", a.port)
        router.add_replica("b", "127.0.0.1", b.port)
        outs = [
            router.dispatch({"prompt": [1, 2, 3], "max_new_tokens": 3,
                             "id": i})
            for i in range(4)
        ]
        assert all(o.get("tokens") == [1, 2, 3] for o in outs)
        assert router.stats()["deaths"] == 1
        done = list(rt.completed)
        assert len(done) == 4 and all(t["status"] == "done" for t in done)
        # the victim's trace spans both replicas under ONE id
        victims = [
            t for t in done
            if any(s["stage"] == "redispatch" for s in t["spans"])
        ]
        assert len(victims) == 1
        v = victims[0]
        fwd = [s for s in v["spans"] if s["stage"] == "forward"]
        assert [s["attrs"]["replica"] for s in fwd] == ["a", "b"]
        assert "error" in fwd[0]["attrs"] and "error" not in fwd[1]["attrs"]
        assert v["attrs"]["redispatches"] == 1
        # the same context hit both replicas' wire payloads
        assert a.payloads[0][TRACE_CTX_KEY]["id"] == v["id"]
        assert v["id"] in [
            p[TRACE_CTX_KEY]["id"] for p in b.payloads
        ]
        assert rt.inflight_ids() == []  # nothing dangles
    finally:
        router.stop()
        a.kill()
        b.kill()


def test_router_shed_at_edge_records_shed_trace(monkeypatch):
    rt = _arm(monkeypatch)
    a = _FakeReplica("a")
    router = FleetRouter(port=0, probe_interval_s=30.0, request_timeout=5.0)
    try:
        router.add_replica("a", "127.0.0.1", a.port)
        out = router.dispatch({"prompt": [1], "max_new_tokens": 1,
                               "deadline_ms": 0})
        assert out["error"] == "shed"
        done = list(rt.completed)
        assert len(done) == 1 and done[0]["status"] == "shed"
        assert [s["stage"] for s in done[0]["spans"]] == ["shed"]
        assert rt.inflight_ids() == []
    finally:
        router.stop()
        a.kill()


def test_all_replicas_dead_finishes_trace_failed(monkeypatch):
    rt = _arm(monkeypatch)
    a = _FakeReplica("a", die_on_request=True)
    router = FleetRouter(port=0, probe_interval_s=30.0, request_timeout=5.0)
    try:
        router.add_replica("a", "127.0.0.1", a.port)
        out = router.dispatch({"prompt": [1], "max_new_tokens": 1})
        assert "error" in out
        done = list(rt.completed)
        assert len(done) == 1 and done[0]["status"] == "failed"
        assert rt.inflight_ids() == []
    finally:
        router.stop()
        a.kill()


def test_sampled_out_requests_carry_no_context(monkeypatch):
    _arm(monkeypatch, ODTP_REQTRACE_SAMPLE="0")
    a = _FakeReplica("a")
    router = FleetRouter(port=0, probe_interval_s=30.0, request_timeout=5.0)
    try:
        router.add_replica("a", "127.0.0.1", a.port)
        out = router.dispatch({"prompt": [1], "max_new_tokens": 1})
        assert out["tokens"] == [1, 2, 3]
        assert TRACE_CTX_KEY not in a.payloads[0]
    finally:
        router.stop()
        a.kill()


# -- serve plane: scheduler and server stage chains (CPU) -----------------------


def _make_batcher(tiny_cfg, **kw):
    from opendiloco_torch.models import llama as tllama
    from opendiloco_torch.serve.engine import ServeEngine
    from opendiloco_torch.serve.scheduler import ContinuousBatcher
    from test_torch_serve_engine import _np_params

    cfg = tllama.LlamaConfig.from_dict(tiny_cfg.to_dict())
    spec_k = kw.pop("spec_k", 0)
    engine = ServeEngine(cfg, _np_params(cfg, seed=0), num_slots=2, max_context=64, prefill_buckets=(8, 16),
                         compute_dtype=torch.float32, device="cpu", spec_k=spec_k)
    return ContinuousBatcher(engine, **kw)


def _complete_chain(tr):
    stages = {s["stage"] for s in tr["spans"]}
    return {"queue", "prefill", "decode", "retire"} <= stages


def test_scheduler_records_complete_stage_chain(monkeypatch, tiny_cfg):
    rt = _arm(monkeypatch)
    batcher = _make_batcher(tiny_cfg).start()
    try:
        ctx = {"id": "sched-1", "o": "test"}
        req = batcher.submit([1, 2, 3], max_new_tokens=4, trace=ctx,
                             priority=1, deadline_ms=30000)
        assert req.wait(30.0) and req.error is None
        tr = rt.get("sched-1")
        assert tr["status"] == "done" and _complete_chain(tr)
        assert tr["attrs"]["priority"] == 1
        assert tr["attrs"]["deadline_ms"] == 30000
        pre = [s for s in tr["spans"] if s["stage"] == "prefill"][0]
        assert pre["attrs"]["tokens"] == 3 and pre["attrs"]["bucket"] == 8
        dec = [s for s in tr["spans"] if s["stage"] == "decode"]
        assert sum(s["attrs"]["tokens"] for s in dec) == len(req.tokens) - 1
        # queue+prefill+decode(+swap) reconcile with e2e within 5%...
        # on a quiet CPU box; here just require they never exceed it
        staged = sum(tr["stages_s"].values())
        assert staged * 1e3 <= tr["e2e_ms"] * 1.05
    finally:
        batcher.stop()


def test_spec_decode_spans_are_token_exact(monkeypatch, tiny_cfg):
    rt = _arm(monkeypatch)
    batcher = _make_batcher(tiny_cfg, spec_k=2).start()
    try:
        req = batcher.submit([1, 2, 3], max_new_tokens=9,
                             trace={"id": "spec-1", "o": "t"})
        assert req.wait(60.0) and req.error is None
        tr = rt.get("spec-1")
        dec = [s for s in tr["spans"] if s["stage"] == "decode"]
        assert dec and all(s["attrs"]["proposed"] == 2 for s in dec)
        assert sum(s["attrs"]["tokens"] for s in dec) == len(req.tokens) - 1
        assert (
            sum(s["attrs"]["accepted"] for s in dec)
            == batcher.spec_accepted
        )
        assert batcher.spec_proposed == 2 * len(dec)
    finally:
        batcher.stop()


def test_scheduler_reject_paths_terminate_traces(monkeypatch, tiny_cfg):
    rt = _arm(monkeypatch)
    batcher = _make_batcher(tiny_cfg, max_queue=0)  # loop never started
    req = batcher.submit([1], max_new_tokens=1, trace={"id": "q-1", "o": "t"})
    assert req.error == "queue full"
    assert rt.get("q-1")["status"] == "shed"
    req = batcher.submit([1], max_new_tokens=1, deadline_ms=0,
                         trace={"id": "d-1", "o": "t"})
    assert req.error == "deadline exceeded"
    assert rt.get("d-1")["status"] == "shed"
    req = batcher.submit([], max_new_tokens=1, trace={"id": "e-1", "o": "t"})
    assert req.error == "empty prompt"
    assert rt.get("e-1")["status"] == "failed"
    assert rt.inflight_ids() == []


def _http_generate(port, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())


def test_http_edge_mints_and_chain_completes(monkeypatch, tiny_cfg):
    from opendiloco_torch.serve.server import ServeServer

    rt = _arm(monkeypatch)
    rt.set_identity("s0")
    batcher = _make_batcher(tiny_cfg).start()
    srv = ServeServer(batcher, port=0)
    try:
        status, out = _http_generate(
            srv.port, {"prompt": [1, 2, 3], "max_new_tokens": 3, "id": 1}
        )
        assert status == 200 and len(out["tokens"]) >= 1
        done = list(rt.completed)
        assert len(done) == 1
        tr = done[0]
        assert tr["id"].startswith("s0-")  # minted at the server edge
        assert tr["status"] == "done" and _complete_chain(tr)
    finally:
        srv.stop()
        batcher.stop()


def test_jsonl_edge_adopts_client_context(monkeypatch, tiny_cfg):
    from opendiloco_torch.serve.server import ServeServer

    rt = _arm(monkeypatch)
    batcher = _make_batcher(tiny_cfg).start()
    srv = ServeServer(batcher, port=0)
    try:
        with socket.create_connection(("127.0.0.1", srv.port), 10) as conn:
            conn.sendall((json.dumps({
                "prompt": [1, 2], "max_new_tokens": 2, "id": 5,
                TRACE_CTX_KEY: {"id": "cli-5", "o": "bench"},
            }) + "\n").encode())
            buf = b""
            while b"\n" not in buf:
                buf += conn.recv(65536)
        out = json.loads(buf.decode())
        assert out["id"] == 5 and "error" not in out
        tr = rt.get("cli-5")
        assert tr is not None and tr["status"] == "done"
        assert tr["origin"] == "bench" and _complete_chain(tr)
    finally:
        srv.stop()
        batcher.stop()


def test_http_503_shed_still_records_trace(monkeypatch, tiny_cfg):
    from opendiloco_torch.serve.server import ServeServer

    rt = _arm(monkeypatch)
    batcher = _make_batcher(tiny_cfg, max_queue=0)  # always full, no loop
    srv = ServeServer(batcher, port=0)
    try:
        status, out = _http_generate(
            srv.port, {"prompt": [1], "max_new_tokens": 1, "id": 2}
        )
        assert status == 503 and out["error"] == "queue full"
        done = list(rt.completed)
        assert len(done) == 1 and done[0]["status"] == "shed"
        assert [s["stage"] for s in done[0]["spans"]] == ["shed"]
        assert done[0]["attrs"]["reason"] == "queue_full"
    finally:
        srv.stop()
        batcher.stop()


def test_health_carries_slo_exemplars(monkeypatch, tiny_cfg):
    rt = _arm(monkeypatch)
    batcher = _make_batcher(tiny_cfg).start()
    try:
        req = batcher.submit([1, 2], max_new_tokens=2,
                             trace={"id": "h-1", "o": "t"})
        assert req.wait(30.0) and req.error is None
        assert rt.get("h-1")["status"] == "done"
        h = batcher.health()
        assert h["slo_exemplars"] == ["h-1"]
    finally:
        batcher.stop()
    # disarmed: the field is simply absent (old-consumer compatible)
    obs.reset()
    monkeypatch.delenv("ODTP_OBS", raising=False)
    batcher2 = _make_batcher(tiny_cfg)
    assert "slo_exemplars" not in batcher2.health()


def test_jax_router_pulls_a_port_replicas_spans(monkeypatch, tiny_cfg):
    """The JAX router in front of a port replica, both packages armed: the
    router's trace id rides the request to the replica, and the replica's
    ``reqtrace`` frame (asked through the JAX push wire) answers that
    request's complete stage chain under the same id."""
    from opendiloco_tpu import obs as jobs
    from opendiloco_tpu.fleet import wire as jfwire
    from opendiloco_tpu.fleet.router import FleetRouter as JFleetRouter
    from opendiloco_torch.fleet import FleetManager
    from opendiloco_torch.fleet.publisher import DeltaPublisher
    from opendiloco_torch.fleet.replica import Replica
    from test_torch_fleet import _port_cfg, _tiny_masters, wait

    jobs.reset()
    _arm(monkeypatch)
    jrt = jobs.reqtrace.ring()
    jrt.set_identity("router")
    masters = _tiny_masters(tiny_cfg)
    pub = DeltaPublisher(lambda: (0, masters), codec="blockwise4bit", fragments=2, keyframe_every=4)
    mgr = FleetManager(pub, None, push_interval_s=0.05)
    rep = Replica("port", _port_cfg(tiny_cfg), max_queue=64, device="cpu", num_slots=2, max_context=64,
                  prefill_buckets=(8, 16))
    router = JFleetRouter(port=0, probe_interval_s=30.0, request_timeout=60.0)
    try:
        mgr.attach("port", "127.0.0.1", rep.server.port, "127.0.0.1", rep.push_port)
        assert wait(rep.ready), "the replica never onboarded from a keyframe"
        router.add_replica("port", "127.0.0.1", rep.server.port)
        out = router.dispatch({"prompt": [1, 2, 3, 4], "max_new_tokens": 3, "id": 5})
        assert len(out["tokens"]) == 3 and "error" not in out
        (jtrace,) = list(jrt.completed)
        assert [s["stage"] for s in jtrace["spans"]] == ["admit", "forward"]
        assert jtrace["spans"][1]["attrs"]["replica"] == "port"
        assert wait(lambda: reqtrace.ring().get(jtrace["id"]) is not None, 10)
        with socket.create_connection(("127.0.0.1", rep.push_port), timeout=10) as conn:
            jfwire.send_frame(conn, "reqtrace", {"recent": 8})
            msg, meta, _ = jfwire.recv_frame(conn, timeout=10.0)
        assert msg == "ok" and meta["replica"] == "port"
        (row,) = [r for r in meta["reqtrace"]["recent"] if r["id"] == jtrace["id"]]
        assert row["status"] == "done"
        assert {"queue", "prefill", "decode", "retire"} <= set(row["stages_ms"])
        assert all(v >= 0.0 and v == v for v in row["stages_ms"].values())
    finally:
        router.stop()
        mgr.stop()
        rep.stop()
        jobs.reset()
