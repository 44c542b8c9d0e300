"""The port's socket front end (``opendiloco_torch/serve/server.py``)
against the JAX package's, over CPU engines at ``tiny_cfg`` size.

The patterns are those of ``tests/test_serve.py``: a port in use falls
back to an ephemeral one, HTTP and pipelined JSONL on one port, the
batcher's health vector and wait estimate, a full queue answered with a
structured 503 and ``Retry-After``, and a generation that outlasts the
request timeout. The same requests sent to a JAX server and a
port server holding the same weights get the same bodies, field for
field, apart from timings.
"""
import json
import socket
import threading
import time
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opendiloco_tpu.config import ServeConfig as JServeConfig
from opendiloco_tpu.serve.engine import ServeEngine as JServeEngine
from opendiloco_tpu.serve.scheduler import ContinuousBatcher as JBatcher
from opendiloco_tpu.serve.server import ServeServer as JServeServer
from opendiloco_torch.config import Config, ServeConfig, parse_argv
from opendiloco_torch.models import llama as tllama
from opendiloco_torch.serve import ContinuousBatcher, ServeEngine, ServeServer, build_serving
from opendiloco_torch.serve import server as tserver
from test_torch_serve_engine import _generate, _np_params

torch.set_num_threads(2)

GEOM = dict(num_slots=4, max_context=64, prefill_buckets=(8, 16, 32))
TIMINGS = ("latency_ms",)


@pytest.fixture
def cfg(tiny_cfg):
    return tllama.LlamaConfig.from_dict(tiny_cfg.to_dict())


def _port_engine(cfg, params, **kw):
    return ServeEngine(cfg, params, compute_dtype=torch.float32, device="cpu", **{**GEOM, **kw})


def _jax_engine(tiny_cfg, params, **kw):
    return JServeEngine(tiny_cfg, params, compute_dtype=jnp.float32, decode_kernel="xla", **{**GEOM, **kw})


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
        return r.status, json.loads(r.read())


def _post(port, body: bytes, path="/generate"):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body, method="POST",
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, dict(r.headers), json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


def _jsonl(port, payloads) -> list:
    with socket.create_connection(("127.0.0.1", port), timeout=30) as conn:
        conn.sendall(b"".join(json.dumps(p).encode() + b"\n" for p in payloads))
        buf = b""
        while buf.count(b"\n") < len(payloads):
            chunk = conn.recv(4096)
            assert chunk, "connection closed early"
            buf += chunk
    return [json.loads(x) for x in buf.decode().splitlines()]


def test_serve_port_collision_falls_back(cfg):
    batcher = ContinuousBatcher(_port_engine(cfg, _np_params(cfg))).start()
    blocker = socket.socket()
    blocker.bind(("127.0.0.1", 0))
    blocker.listen(1)
    taken = blocker.getsockname()[1]
    try:
        srv = ServeServer(batcher, port=taken)
        assert srv.port != taken  # downgraded, not dead
        srv.stop()
    finally:
        blocker.close()
        batcher.stop()


def test_http_and_jsonl_frontend(cfg):
    params = _np_params(cfg, 3)
    batcher = ContinuousBatcher(_port_engine(cfg, params)).start()
    srv = ServeServer(batcher, port=0)
    try:
        status, _, out = _post(srv.port, json.dumps({"prompt": [5, 6, 7], "max_new_tokens": 4}).encode())
        assert status == 200 and len(out["tokens"]) == 4 and "error" not in out
        # the HTTP answer is the engine's, driven directly
        assert out["tokens"] == _generate(_port_engine(cfg, params, num_slots=1), [5, 6, 7], 4)
        assert out["epoch"] == 0 and out["latency_ms"] > 0

        status, health = _get(srv.port, "/healthz")
        assert status == 200 and health == {"ok": True, "weights_epoch": 0, "staleness": 0, "free_slots": 4}
        _, stats = _get(srv.port, "/stats")
        assert stats["completed"] >= 1 and stats["failed"] == 0
        assert stats["rejected_total"] == 0

        # JSONL on the same port: two pipelined lines, ids echoed, in order
        lines = _jsonl(srv.port, [{"prompt": [9, i], "max_new_tokens": 2, "id": i} for i in range(2)])
        assert [x["id"] for x in lines] == [0, 1]
        assert all(len(x["tokens"]) == 2 for x in lines)

        assert _post(srv.port, b"{not json")[2] == {"error": "malformed JSON body"}
        assert _post(srv.port, b"{}", path="/nowhere")[0] == 404
        # a "trace" field is ignored (request tracing is not ported)
        traced = {"prompt": [5, 6, 7], "max_new_tokens": 4, "trace": {"id": "t1"}}
        assert _post(srv.port, json.dumps(traced).encode())[2]["tokens"] == out["tokens"]
    finally:
        srv.stop()
        batcher.stop()


def test_health_vector_and_wait_estimate(cfg):
    engine = _port_engine(cfg, _np_params(cfg), num_slots=2)
    batcher = ContinuousBatcher(engine)  # loop never started
    h = batcher.health()
    assert h["queue_depth"] == 0 and h["p99_ms"] is None
    assert h["occupancy"] == 0.0 and h["shed"] == 0 and h["completed"] == 0
    for _ in range(8):
        batcher.submit([1, 2, 3])
    # 8 queued over 2 slots at the 0.25 s default EWMA: 1 s
    assert batcher.estimate_wait_s() == pytest.approx(1.0)
    assert batcher.health()["queue_depth"] == 8 and batcher.health()["wait_estimate_s"] == 1.0


def test_latency_ewma_paces_the_wait_estimate(cfg):
    batcher = ContinuousBatcher(_port_engine(cfg, _np_params(cfg), num_slots=2)).start()
    try:
        reqs = [batcher.submit([1, 2, 3], max_new_tokens=3) for _ in range(3)]
        assert all(r.wait(60) and r.error is None for r in reqs)
    finally:
        batcher.stop()
    lat = [r.latency_s for r in reqs]
    ewma = lat[0]
    for x in lat[1:]:
        ewma = 0.8 * ewma + 0.2 * x
    assert batcher._lat_ewma == pytest.approx(ewma)
    assert batcher.health()["p99_ms"] > 0


def test_server_queue_full_is_structured_503(cfg):
    """A full queue answers HTTP 503 + Retry-After with a JSON body that
    carries retry_after_s, and /stats counts the reject."""
    batcher = ContinuousBatcher(_port_engine(cfg, _np_params(cfg)), max_queue=0)  # always full
    srv = ServeServer(batcher, port=0)
    try:
        status, headers, body = _post(srv.port, json.dumps({"prompt": [1, 2, 3]}).encode())
        assert status == 503
        assert float(headers["Retry-After"]) >= 0.1
        assert body["error"] == "queue full" and body["retry_after_s"] >= 0.1
        assert _get(srv.port, "/stats")[1]["rejected_total"] == 1
        # a spent deadline is the other overload answer
        status, _, body = _post(srv.port, json.dumps({"prompt": [1], "deadline_ms": 0}).encode())
        assert status == 503 and body["error"] == "deadline exceeded"
    finally:
        srv.stop()


def test_request_timeout_answers_like_jax(tiny_cfg, cfg, monkeypatch):
    """A generation that outlasts the request timeout (the batcher loop is
    never started, so nothing is decoded) is given up and answered as the
    JAX server answers it."""
    params = _np_params(cfg)
    monkeypatch.setattr(tserver, "_REQUEST_TIMEOUT_S", 0.3)
    js = JServeServer(JBatcher(_jax_engine(tiny_cfg, params)), port=0, request_timeout=0.3)
    ts = ServeServer(ContinuousBatcher(_port_engine(cfg, params)), port=0)
    try:
        body = json.dumps({"prompt": [1, 2, 3], "max_new_tokens": 2, "id": "t"}).encode()
        (jst, _, jout), (tst, _, tout) = _post(js.port, body), _post(ts.port, body)
        assert (tst, tout) == (jst, jout) == (400, {"error": "timeout", "id": "t"})
    finally:
        js.stop()
        ts.stop()


def _strip(body: dict) -> dict:
    return {k: v for k, v in body.items() if k not in TIMINGS}


def test_bodies_match_the_jax_server(tiny_cfg, cfg):
    """The same requests to a JAX server and a port server that hold the
    same weights: status, headers that matter and bodies, field for
    field, apart from timings."""
    params = _np_params(cfg, 7)
    jb = JBatcher(_jax_engine(tiny_cfg, params)).start()
    tb = ContinuousBatcher(_port_engine(cfg, params)).start()
    js, ts = JServeServer(jb, port=0), ServeServer(tb, port=0)
    rng = np.random.default_rng(5)
    requests = [
        {"prompt": rng.integers(1, 256, 6).tolist(), "max_new_tokens": 5},
        {"prompt": rng.integers(1, 256, 20).tolist(), "max_new_tokens": 3, "id": "x", "eos_id": None},
        {"prompt": rng.integers(1, 256, 40).tolist(), "max_new_tokens": 2},  # beyond the largest bucket
        {"prompt": [], "max_new_tokens": 2},
        {"prompt": [3, 4], "max_new_tokens": 0},
        {"prompt": [3, 4], "max_new_tokens": 2, "priority": 1, "deadline_ms": 60000},
    ]
    try:
        for payload in requests:
            body = json.dumps(payload).encode()
            (jst, _, jout), (tst, _, tout) = _post(js.port, body), _post(ts.port, body)
            assert tst == jst and _strip(tout) == _strip(jout), payload
        assert [_strip(x) for x in _jsonl(ts.port, requests)] == [_strip(x) for x in _jsonl(js.port, requests)]
        for path in ("/healthz", "/nowhere"):
            try:
                want = _get(js.port, path)
            except urllib.error.HTTPError as e:
                want = (e.code, json.loads(e.read()))
            try:
                got = _get(ts.port, path)
            except urllib.error.HTTPError as e:
                got = (e.code, json.loads(e.read()))
            assert got == want, path
        (jst, _, jout), (tst, _, tout) = _post(js.port, b"[1,"), _post(ts.port, b"[1,")
        assert (tst, tout) == (jst, jout)
        jstats, tstats = _get(js.port, "/stats")[1], _get(ts.port, "/stats")[1]
        for key in ("completed", "rejected", "failed", "new_tokens", "weight_swaps", "weights_epoch",
                    "staleness", "rejected_total"):
            assert tstats[key] == jstats[key], key
    finally:
        js.stop()
        ts.stop()
        jb.stop()
        tb.stop()


def test_stop_ends_the_server_and_fails_requests_in_flight(cfg):
    """ServingPlane.stop ends the accept loop and the batcher in bounded
    time: a request in flight fails with "server stopped", and the port
    refuses new connections."""
    plane = build_serving(ServeConfig(max_batch=1, max_context=64, prefill_buckets=[16]), cfg,
                          _np_params(cfg), compute_dtype=torch.float32, device="cpu")
    port = plane.port
    assert port and plane.server.port == port
    box = {}

    def client():
        box["out"] = _post(port, json.dumps({"prompt": [1, 2, 3], "max_new_tokens": 10_000}).encode())

    t = threading.Thread(target=client)
    t.start()
    deadline = time.monotonic() + 30
    while plane.batcher.stats()["active"] == 0 and time.monotonic() < deadline:
        time.sleep(0.01)
    t0 = time.monotonic()
    plane.stop()
    assert time.monotonic() - t0 < 10
    t.join(timeout=30)
    status, _, body = box["out"]
    assert status == 400 and body["error"] == "server stopped"
    assert not plane.server._thread.is_alive()
    with pytest.raises(OSError):
        socket.create_connection(("127.0.0.1", port), timeout=5).close()


def test_jax_serve_config_dict_constructs_the_ports():
    """A JAX ServeConfig with the front-end, hot-swap and KV-tier fields
    set builds the port's with the same values (the decode-kernel field,
    a residue of the JAX package, is left out of the dict), and the CLI
    parses them."""
    ref = JServeConfig(enabled=True, host="0.0.0.0", port=8123, swap_every_steps=4, max_stale_rounds=2,
                       max_batch=4, max_context=512, prefill_buckets=[64, 256], weight_format="w4",
                       kv_tier=True, kv_tier_codec="blockwise4bit", kv_host_slots=9)
    d = {k: v for k, v in ref.model_dump().items() if k != "decode_kernel"}
    ours = ServeConfig(**d)
    assert {k: getattr(ours, k) for k in d} == d
    # the residue is refused, not ignored
    with pytest.raises(TypeError, match="decode_kernel"):
        ServeConfig(**ref.model_dump())
    argv = ["--serve.enabled", "--serve.host", "0.0.0.0", "--serve.port", "8123", "--serve.swap-every-steps", "4",
            "--serve.max-stale-rounds", "2", "--serve.kv-tier", "--serve.kv-tier-codec", "blockwise4bit",
            "--serve.kv-host-slots", "9"]
    cli = Config(**parse_argv(argv)).serve
    assert (cli.enabled, cli.host, cli.port, cli.swap_every_steps, cli.max_stale_rounds) == (True, "0.0.0.0", 8123, 4, 2)
    assert (cli.kv_tier, cli.kv_tier_codec, cli.kv_host_slots) == (True, "blockwise4bit", 9)
