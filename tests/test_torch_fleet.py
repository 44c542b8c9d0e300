"""The port's serving fleet against the JAX package's, on the CPU.

The patterns of ``tests/test_fleet.py`` on the port's ``fleet/``: the
publisher's delta and keyframe frames, the push wire, ``FleetConfig``,
the router (over the reference suite's fake replicas), replicas in
process and as ``python -m opendiloco_torch.fleet.replica`` processes,
``train()`` with a fleet, and the server's identity and disconnects.

Where the two packages meet, the bar is **bit for bit** (or byte for
byte): publisher frames (meta and payload) and push-wire frames are the
JAX package's bytes for the same inputs and cross both ways; a port
replica given a JAX publisher's frames installs the leaves a JAX replica
installs; replica streams equal those of a ``ServeEngine`` holding the
same decoded masters (the same engine code on the same weights, one
request at a time). A port replica process behind the JAX router, on the
same frames, answers the prompts as a JAX replica does, token for token:
both engines compute in f32 and the prompts are short; the JAX engine's
greedy decode and the port's agree token for token at this size in
``tests/test_torch_serve_engine.py``.
"""
import json
import socket
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from opendiloco_tpu.config import FleetConfig as JFleetConfig
from opendiloco_tpu.fleet import publisher as jpub
from opendiloco_tpu.fleet import wire as jwire
from opendiloco_torch.config import Config, FleetConfig
from opendiloco_torch.diloco import LoopbackWorld
from opendiloco_torch.fleet import FleetManager, spawn_replica
from opendiloco_torch.fleet import publisher as tpub
from opendiloco_torch.fleet import wire as twire
from opendiloco_torch.fleet.router import FleetRouter
from opendiloco_torch.models import llama as tllama
from test_fleet import FakeReplica, HangingReplica, _masters, _walk

torch.set_num_threads(2)

ENGINE_GEOM = dict(num_slots=4, max_context=64, prefill_buckets=(8, 16, 32))


def _equal(a, b):
    return len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))


def wait(pred, t=60.0):
    deadline = time.monotonic() + t
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


# ---------------------------------------------------------------------------
# publisher and apply_frame, against the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("codec", ["blockwise4bit", "topk"])
@pytest.mark.parametrize("ef", [True, False])
def test_delta_frames_round_trip_and_equal_the_reference(codec, ef):
    """A follower of the port's frames holds the publisher's shadow bit
    for bit at every epoch (keyframes and staggered deltas); each frame's
    meta and payload are the JAX publisher's; each package's apply_frame
    takes the other's frames to the same leaves."""
    rng = np.random.default_rng(0)
    masters = _masters(rng)
    epoch = [0]
    snap = lambda: (epoch[0], masters)  # noqa: E731
    kw = dict(codec=codec, fragments=2, keyframe_every=4, error_feedback=ef)
    pub, ref = tpub.DeltaPublisher(snap, **kw), jpub.DeltaPublisher(snap, **kw)
    mine = theirs = None
    kinds = []
    for e in range(10):
        epoch[0] = e
        if e:
            _walk(masters, rng)
        frames, jframes = pub.frames("r0"), ref.frames("r0")
        assert len(frames) == 1
        (meta, payload), (jmeta, jpayload) = frames[0], jframes[0]
        assert json.dumps(meta, sort_keys=True) == json.dumps(jmeta, sort_keys=True)
        assert payload == jpayload
        kinds.append(meta["kind"])
        mine, got_epoch = tpub.apply_frame(mine, jmeta, jpayload)  # JAX frames into the port
        theirs, _ = jpub.apply_frame(theirs, meta, payload)  # and back
        assert got_epoch == e
        assert _equal(mine, pub._channels["r0"].shadow) and _equal(mine, theirs)
        assert pub.frames("r0") == []
    assert [k == "keyframe" for k in kinds] == [e % 4 == 0 for e in range(10)]
    assert pub.stats() == ref.stats()


@pytest.mark.parametrize("codec", ["blockwise4bit", "topk"])
def test_keyframe_boundary_equals_a_fresh_install(codec):
    rng = np.random.default_rng(1)
    masters = _masters(rng)
    epoch = [0]
    pub = tpub.DeltaPublisher(lambda: (epoch[0], masters), codec=codec, fragments=3, keyframe_every=3)
    follower = None
    for e in range(9):
        epoch[0] = e
        if e:
            _walk(masters, rng)
        for meta, payload in pub.frames("old"):
            follower, _ = tpub.apply_frame(follower, meta, payload)
        if e % 3 == 0:
            frames = pub.frames(f"fresh{e}")
            assert [m["kind"] for m, _ in frames] == ["keyframe"]
            fresh, fe = tpub.apply_frame(None, *frames[0])
            assert fe == e and _equal(follower, fresh)


def test_delta_bytes_budget_rejects_and_resets(monkeypatch):
    rng = np.random.default_rng(2)
    masters = _masters(rng, shapes=((4096,), (512, 8), (9000,)))
    epoch = [0]
    pub = tpub.DeltaPublisher(lambda: (epoch[0], masters), codec="blockwise4bit", fragments=4, keyframe_every=64)
    for e in range(9):
        epoch[0] = e
        if e:
            _walk(masters, rng)
        pub.frames("r0")
    st = pub.stats()["replicas"]["r0"]
    assert st["delta_frames"] == 8 and st["keyframe_frames"] == 1
    assert st["delta_bytes"] / st["delta_frames"] <= pub.fp16_snapshot_bytes / 4
    with pytest.raises(tpub.FleetFrameError):
        tpub.apply_frame(None, {"kind": "delta", "codec": "topk", "epoch": 1, "leaves": []}, b"")
    with pytest.raises(tpub.FleetFrameError):
        tpub.apply_frame([], {"kind": "ping"}, b"")
    # reset forgets the shadow: the next push is a keyframe
    epoch[0] = 9
    _walk(masters, rng)
    assert pub.frames("r0")[0][0]["kind"] == "delta" and pub.channel_epoch("r0") == 9
    pub.reset("r0")
    assert pub.channel_epoch("r0") == -1 and pub.frames("r0")[0][0]["kind"] == "keyframe"
    monkeypatch.setenv("ODTP_FLEET_KEYFRAME_EVERY", "2")
    assert tpub.DeltaPublisher(lambda: (0, []), keyframe_every=8).keyframe_every == 2


def _wire_bytes(send, *args) -> bytes:
    a, b = socket.socketpair()
    try:
        send(a, *args)
        a.shutdown(socket.SHUT_WR)
        out = b""
        while True:
            chunk = b.recv(65536)
            if not chunk:
                return out
            out += chunk
    finally:
        a.close()
        b.close()


def test_fleet_wire_bytes_equal_the_reference_and_cross_both_ways():
    payload = bytes(range(256)) * 3
    for args in (("delta", {"kind": "delta", "epoch": 7}, payload), ("ping", {"kind": "ping", "tepoch": 3})):
        assert _wire_bytes(twire.send_frame, *args) == _wire_bytes(jwire.send_frame, *args)
    for send, recv in ((twire.send_frame, jwire.recv_frame), (jwire.send_frame, twire.recv_frame)):
        a, b = socket.socketpair()
        try:
            send(a, "delta", {"kind": "delta", "epoch": 7}, payload)
            assert recv(b, timeout=5.0) == ("delta", {"kind": "delta", "epoch": 7}, payload)
        finally:
            a.close()
            b.close()
    a, b = socket.socketpair()
    try:
        a.sendall(b"JUNKJUNKJUNK")
        with pytest.raises(twire.FleetWireError):
            twire.recv_frame(b, timeout=5.0)
    finally:
        a.close()
        b.close()


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bad", [
    dict(replicas=0), dict(fragments=0), dict(keyframe_every=0), dict(max_stale_rounds=-1),
    dict(prefill_buckets=[]), dict(prefill_buckets=[512], max_context=256), dict(min_replicas=0),
    dict(min_replicas=3, max_replicas=2), dict(warm_spares=-1), dict(slo_p99_ms=-1.0), dict(slo_queue_depth=0),
    dict(scale_up_evals=0), dict(scale_down_evals=0),
])
def test_fleet_config_errors_are_the_reference_errors(bad):
    with pytest.raises(ValueError) as ours:
        FleetConfig(**bad)
    with pytest.raises(ValueError) as theirs:
        JFleetConfig(**bad)
    assert str(ours.value) in str(theirs.value)


def test_fleet_config_fields_and_defaults_are_the_reference_ones():
    import dataclasses

    jc, tc = JFleetConfig(), FleetConfig()
    names = [f.name for f in dataclasses.fields(FleetConfig)]
    assert names == list(JFleetConfig.model_fields)
    assert all(getattr(tc, n) == getattr(jc, n) for n in names)
    assert FleetConfig(enabled=True, replicas=3, prefill_buckets="8,32").prefill_buckets == [8, 32]
    with pytest.raises(ValueError):
        FleetConfig(codec="fp97")
    # from the command line, as strings
    cfg = Config(fleet={"enabled": "true", "replicas": "3", "keyframe_every": "2", "inprocess": "1"})
    assert (cfg.fleet.enabled, cfg.fleet.replicas, cfg.fleet.keyframe_every, cfg.fleet.inprocess) == (True, 3, 2, True)


# ---------------------------------------------------------------------------
# the router, over the reference suite's fake replicas
# ---------------------------------------------------------------------------


def test_router_redispatch_drops_nothing_on_replica_death():
    a, b = FakeReplica("a", die_on_request=True), FakeReplica("b")
    router = FleetRouter(port=0, probe_interval_s=30.0, request_timeout=10.0)
    try:
        router.add_replica("a", "127.0.0.1", a.port)
        router.add_replica("b", "127.0.0.1", b.port)
        outs = [router.dispatch({"prompt": [1, 2, 3], "max_new_tokens": 3, "id": i}) for i in range(6)]
        assert all(o.get("tokens") == [1, 2, 3] for o in outs) and [o["id"] for o in outs] == list(range(6))
        st = router.stats()
        assert st["deaths"] == 1 and st["redispatches"] >= 1
        assert st["replicas"]["a"]["dead"] and not st["replicas"]["b"]["dead"] and b.served == 6
    finally:
        router.stop()
        a.kill()
        b.kill()


def test_router_probe_revives_a_rejoined_replica():
    a = FakeReplica("a")
    router = FleetRouter(port=0, probe_interval_s=0.1, request_timeout=5.0)
    try:
        router.add_replica("a", "127.0.0.1", a.port)
        assert router.dispatch({"prompt": [1], "max_new_tokens": 1})["tokens"]
        port = a.port
        a.kill()
        assert "error" in router.dispatch({"prompt": [1], "max_new_tokens": 1})
        assert router.stats()["replicas"]["a"]["dead"]
        deadline = time.monotonic() + 10
        while True:
            try:
                a = FakeReplica("a", port=port)
                break
            except OSError:
                if time.monotonic() >= deadline:
                    raise
                time.sleep(0.1)
        deadline = time.monotonic() + 10
        out = {}
        while "tokens" not in out and time.monotonic() < deadline:
            out = router.dispatch({"prompt": [1], "max_new_tokens": 1})
            time.sleep(0.05)
        assert out.get("tokens") == [1, 2, 3] and not router.stats()["replicas"]["a"]["dead"]
    finally:
        router.stop()
        a.kill()


def test_router_prefers_fresh_over_stale():
    a, b = FakeReplica("a", stale=True), FakeReplica("b")
    router = FleetRouter(port=0, probe_interval_s=0.1, request_timeout=5.0)
    try:
        router.add_replica("a", "127.0.0.1", a.port)
        router.add_replica("b", "127.0.0.1", b.port)
        assert wait(lambda: router.stats()["replicas"]["a"]["stale"], 10)
        for _ in range(4):
            assert router.dispatch({"prompt": [1]}).get("tokens")
        assert b.served == 4 and a.served == 0
        b.kill()
        assert wait(lambda: router.stats()["replicas"]["b"]["dead"], 10)
        assert router.dispatch({"prompt": [1]}).get("tokens") and a.served >= 1
    finally:
        router.stop()
        a.kill()
        b.kill()


def test_router_prefix_affinity_and_directory():
    from opendiloco_torch.serve.kvcache import prefix_key

    router = FleetRouter(port=0, probe_interval_s=30.0, prefix_directory=True)
    try:
        router.add_replica("a", "127.0.0.1", 1)  # never dialed: _pick only
        router.add_replica("b", "127.0.0.1", 2)
        warm, cold = router._backends["b"], router._backends["a"]
        sysp = list(range(100, 120))
        warm.recent.append(sysp + [7, 8])
        warm.inflight = 1
        assert router._pick(sysp + [40, 41], set()) is warm
        assert router._pick([1, 2], set()) is cold
        assert router._pick(list(range(500, 520)), set()) is cold
        warm.inflight = cold.inflight + router.affinity_max_extra_inflight + 1
        assert router._pick(sysp + [40, 41], set()) is cold
        # the directory: an advertised prefix routes to its holder first,
        # and leaves with the holder's death
        warm.inflight = 0
        other = list(range(300, 316))
        router.update_prefixes("a", [[prefix_key(other, 16), 16]])
        assert router._pick(other + [1, 2, 3], set()) is cold and router.directory_hits == 1
        router._mark_dead(cold)
        assert router.stats()["prefix_directory"]["entries"] == 0
    finally:
        router.stop()


def test_router_http_front_end_health_and_stats():
    a = FakeReplica("a")
    router = FleetRouter(port=0, probe_interval_s=30.0, request_timeout=5.0)
    try:
        router.add_replica("a", "127.0.0.1", a.port)
        req = urllib.request.Request(f"http://127.0.0.1:{router.port}/generate",
                                     data=json.dumps({"prompt": [5, 6], "max_new_tokens": 2}).encode())
        with urllib.request.urlopen(req, timeout=10) as r:
            assert json.loads(r.read())["tokens"] == [1, 2, 3]
        with urllib.request.urlopen(f"http://127.0.0.1:{router.port}/healthz", timeout=10) as r:
            health = json.loads(r.read())
        assert health["ok"] and health["live"] == 1
        with urllib.request.urlopen(f"http://127.0.0.1:{router.port}/stats", timeout=10) as r:
            assert json.loads(r.read())["replicas"]["a"]["dispatched"] == 1
    finally:
        router.stop()
        a.kill()


def test_router_mark_dead_under_concurrent_dispatch():
    hang, good = HangingReplica(), FakeReplica("b")
    router = FleetRouter(port=0, probe_interval_s=30.0, request_timeout=10.0)
    try:
        router.add_replica("a", "127.0.0.1", hang.port)
        outs = [None, None]

        def go(i):
            outs[i] = router.dispatch({"prompt": [1, 2, 3], "max_new_tokens": 3, "id": i})

        threads = [threading.Thread(target=go, args=(i,), daemon=True) for i in range(2)]
        for t in threads:
            t.start()
        assert hang.arrived.acquire(timeout=5.0) and hang.arrived.acquire(timeout=5.0)
        router.add_replica("b", "127.0.0.1", good.port)
        hang.kill()
        for t in threads:
            t.join(timeout=10.0)
        assert all(o is not None and o.get("tokens") == [1, 2, 3] for o in outs)
        st = router.stats()
        assert st["deaths"] == 1 and st["redispatches"] == 2 and good.served == 2
    finally:
        router.stop()
        hang.kill()
        good.kill()
    router = FleetRouter(port=0, probe_interval_s=30.0)
    try:
        router.add_replica("a", "127.0.0.1", 1)
        threads = [threading.Thread(target=router._mark_dead, args=(router._backends["a"],)) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert router.stats()["deaths"] == 1
    finally:
        router.stop()


def test_router_sheds_unmeetable_deadlines_with_a_503():
    rep = FakeReplica("a")
    router = FleetRouter(port=0, probe_interval_s=30.0, request_timeout=10.0)
    try:
        router.add_replica("a", "127.0.0.1", rep.port)
        for i in range(3):
            assert router.dispatch({"prompt": [1, 2, 3], "id": i}).get("tokens") == [1, 2, 3]
        out = router.dispatch({"prompt": [1, 2, 3], "deadline_ms": 0, "id": 99})
        assert out["error"] == "shed" and out["reason"] == "deadline unmeetable"
        assert out["retry_after_s"] > 0 and out["id"] == 99
        assert router.dispatch({"prompt": [1, 2, 3], "deadline_ms": 60000}).get("tokens") == [1, 2, 3]
        req = urllib.request.Request(f"http://127.0.0.1:{router.port}/generate",
                                     data=json.dumps({"prompt": [1, 2, 3], "deadline_ms": 0}).encode(),
                                     method="POST")
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=10)
        assert ei.value.code == 503 and float(ei.value.headers["Retry-After"]) > 0
        assert json.loads(ei.value.read())["error"] == "shed"
        assert router.stats()["shed"] == 2
    finally:
        router.stop()
        rep.kill()


def test_probe_backoff_doubles_jitters_and_snaps_back():
    router = FleetRouter(port=0, probe_interval_s=1.0)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    try:
        router.add_replica("a", "127.0.0.1", port)
        b = router._backends["a"]
        assert b.probe_backoff == 1.0
        cap = router.probe_backoff_cap_s
        seen = []
        for _ in range(6):
            t0 = time.monotonic()
            router._probe(b)
            router._reschedule_probe(b)
            seen.append(b.probe_backoff)
            assert 0.75 * b.probe_backoff - 0.05 <= b.probe_at - t0 <= 1.25 * b.probe_backoff + 0.05
        assert seen == [2.0, 4.0, 8.0, cap, cap, cap]
        rep = FakeReplica("a", port=port)
        try:
            router._probe(b)
            router._reschedule_probe(b)
            assert not b.dead and b.probe_backoff == 1.0
        finally:
            rep.kill()
    finally:
        router.stop()


# ---------------------------------------------------------------------------
# replicas
# ---------------------------------------------------------------------------


def _tiny_masters(tiny_cfg, seed=1):
    from opendiloco_tpu.models.llama import init_params

    return [np.array(x, np.float32) for x in jax.tree.leaves(init_params(jax.random.PRNGKey(seed), tiny_cfg))]


def _port_cfg(tiny_cfg):
    return tllama.LlamaConfig.from_dict(tiny_cfg.to_dict())


def test_replica_follows_pushes_serves_and_reports_staleness(tiny_cfg):
    """Publisher -> manager -> in-process port replica -> router: the
    replica onboards from a keyframe (its engine's leaves the decoded
    keyframe bit for bit), follows staggered deltas, serves through the
    router, and when pushes stall (pings only) its staleness crosses
    max_stale_rounds on /healthz and at the router."""
    from opendiloco_torch.fleet.replica import Replica
    from opendiloco_torch.fleet.wire import recv_frame, send_frame

    masters = _tiny_masters(tiny_cfg)
    epoch = [0]
    pub = tpub.DeltaPublisher(lambda: (epoch[0], masters), codec="blockwise4bit", fragments=4, keyframe_every=8)
    router = FleetRouter(port=0, probe_interval_s=0.2, request_timeout=60.0)
    mgr = FleetManager(pub, router, push_interval_s=0.05)
    rep = Replica("r0", _port_cfg(tiny_cfg), max_stale_rounds=2, max_queue=64, device="cpu", **ENGINE_GEOM)
    try:
        assert not rep.ready()
        mgr.attach("r0", "127.0.0.1", rep.server.port, "127.0.0.1", rep.push_port)
        assert wait(rep.ready), "the replica never onboarded from a keyframe"
        assert rep.engine.weights_epoch == 0
        with rep._lock:
            mailbox = [lf.copy() for lf in rep._leaves]
        assert _equal([p.numpy().reshape(-1) for p in tllama.flatten_params(rep.engine.params)], mailbox)
        rng = np.random.default_rng(9)
        for e in range(1, 6):
            _walk(masters, rng)
            epoch[0] = e
            assert wait(lambda: rep._epoch == e), f"mailbox stuck before {e}"
        assert wait(lambda: rep.engine.weights_epoch == 5)
        assert rep.staleness() == 0 and not rep.stale()
        assert wait(lambda: mgr.health_matrix().get("r0", {}).get("ready") is True)
        out = router.dispatch({"prompt": [1, 2, 3, 4], "max_new_tokens": 4})
        assert len(out["tokens"]) == 4 and "error" not in out and out["epoch"] == 5
        mgr.stop()
        router.add_replica("r0", "127.0.0.1", rep.server.port)
        conn = socket.create_connection(("127.0.0.1", rep.push_port), timeout=10)
        for te in range(6, 12):
            send_frame(conn, "ping", {"kind": "ping", "tepoch": te})
            assert recv_frame(conn, timeout=10.0)[0] == "ok"
        conn.close()
        assert rep.staleness() == 6 and rep.stale()
        with urllib.request.urlopen(f"http://127.0.0.1:{rep.server.port}/healthz", timeout=10) as r:
            health = json.loads(r.read())
        assert health["stale"] is True and health["staleness"] == 6 and health["replica"] == "r0"
        assert wait(lambda: router.stats()["replicas"]["r0"]["stale"], 10)
    finally:
        mgr.stop()
        router.stop()
        rep.stop()


def test_disconnect_mid_generation_retires_the_slot_and_identity_shows(tiny_cfg):
    from opendiloco_torch.serve import ContinuousBatcher, ServeEngine, ServeServer

    params = tllama.init_params(torch.Generator().manual_seed(0), _port_cfg(tiny_cfg))
    engine = ServeEngine(_port_cfg(tiny_cfg), params, compute_dtype=torch.float32, device="cpu", **ENGINE_GEOM)
    batcher = ContinuousBatcher(engine, max_queue=64).start()
    srv = ServeServer(batcher, port=0, identity=lambda: {"worker": "r7", "staleness": 1, "stale": False})
    try:
        conn = socket.create_connection(("127.0.0.1", srv.port), timeout=10)
        # long enough to be mid-generation when the server looks: it watches
        # the socket every 50 ms, and 48 tokens here take about as long (a
        # request that finishes first leaves nothing to cancel)
        conn.sendall((json.dumps({"prompt": [1, 2, 3], "max_new_tokens": 480}) + "\n").encode())
        conn.close()
        assert wait(lambda: batcher.cancelled >= 1, 30)
        assert batcher.cancelled == 1 and batcher.stats()["cancelled"] == 1
        r = batcher.submit([4, 5, 6], max_new_tokens=3)
        assert r.wait(60) and r.error is None
        assert wait(lambda: batcher.slots.num_active == 0, 10)
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/healthz", timeout=10) as r:
            health = json.loads(r.read())
        assert health["worker"] == "r7" and health["staleness"] == 1
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/stats", timeout=10) as r:
            stats = json.loads(r.read())
        assert stats["identity"]["worker"] == "r7" and "staleness" in stats
    finally:
        srv.stop()
        batcher.stop()


def _generate(port, prompt, n):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/generate",
                                 data=json.dumps({"prompt": prompt, "max_new_tokens": n}).encode())
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def test_port_replica_process_behind_the_jax_router_on_jax_frames(tiny_cfg):
    """A JAX DeltaPublisher feeds, through the JAX FleetManager, one JAX
    replica in process, one port replica in process and one port replica
    started as ``python -m opendiloco_torch.fleet.replica --device cpu``.
    After a keyframe and deltas the port replica's mailbox and engine
    leaves equal the JAX replica's bit for bit; behind the JAX router the
    port process answers each prompt as the JAX replica does."""
    from opendiloco_tpu.fleet import FleetManager as JFleetManager
    from opendiloco_tpu.fleet.replica import Replica as JReplica
    from opendiloco_tpu.fleet.router import FleetRouter as JFleetRouter
    from opendiloco_torch.fleet.replica import Replica

    masters = _tiny_masters(tiny_cfg)
    epoch = [0]
    pub = jpub.DeltaPublisher(lambda: (epoch[0], masters), codec="blockwise4bit", fragments=2, keyframe_every=4)
    router = JFleetRouter(port=0, probe_interval_s=0.2, request_timeout=120.0)
    mgr = JFleetManager(pub, None, push_interval_s=0.05)
    geom = dict(num_slots=4, max_context=64, prefill_buckets=[8, 16, 32])
    jrep = JReplica("jax", tiny_cfg, max_queue=64, **geom)
    trep = Replica("port", _port_cfg(tiny_cfg), max_queue=64, device="cpu", **geom)
    proc, info = spawn_replica("proc", _port_cfg(tiny_cfg), serve=dict(geom), device="cpu", timeout=120.0)
    try:
        for rid, rep_port, push in (("jax", jrep.server.port, jrep.push_port),
                                    ("port", trep.server.port, trep.push_port),
                                    ("proc", info["serve_port"], info["push_port"])):
            mgr.attach(rid, "127.0.0.1", rep_port, "127.0.0.1", push)
        rng = np.random.default_rng(4)
        for e in range(3):
            if e:
                _walk(masters, rng)
                epoch[0] = e
            assert wait(lambda: all(pub.channel_epoch(r) == e for r in ("jax", "port", "proc")), 60)
        assert wait(lambda: jrep.engine.weights_epoch == 2 and trep.engine.weights_epoch == 2, 60)
        assert wait(lambda: mgr.status()["replicas"].get("proc", {}).get("weights_epoch") == 2, 60)
        with jrep._lock, trep._lock:
            assert _equal(trep._leaves, jrep._leaves)
        jleaves = [np.asarray(x, np.float32) for x in jax.tree.leaves(jrep.engine.params)]
        assert _equal([p.numpy() for p in tllama.flatten_params(trep.engine.params)], jleaves)
        router.add_replica("proc", "127.0.0.1", info["serve_port"])
        for prompt in ([1, 2, 3, 4], [9, 8, 7, 6, 5, 4, 3], [17] * 12):
            got = router.dispatch({"prompt": prompt, "max_new_tokens": 6})
            want = _generate(jrep.server.port, prompt, 6)
            assert got["tokens"] == want["tokens"] and got["epoch"] == want["epoch"] == 2
        assert router.stats()["replicas"]["proc"]["dispatched"] == 3
    finally:
        mgr.stop()
        router.stop()
        proc.kill()
        proc.wait(timeout=10)
        jrep.stop()
        trep.stop()


# ---------------------------------------------------------------------------
# train() with a fleet, and the control port's "fleet" RPC
# ---------------------------------------------------------------------------


def _train_config(tmp_path, **fleet):
    return Config(path_model="2m", fake_data=True, fake_data_mode="ramp", seq_length=32, per_device_train_batch_size=4,
                  total_batch_size=8, warmup_steps=2, total_steps=8, lr=3e-3, metric_logger_type="dummy",
                  project=str(tmp_path / "metrics.pkl"), precision="fp32",
                  diloco=dict(local_steps=2, backend="loopback", timeout_waiting_for_peers=30.0),
                  fleet=dict(enabled=True, replicas=2, inprocess=True, max_batch=2, max_context=64,
                             prefill_buckets=[16, 32], push_interval_s=0.05, **fleet))


def _encoded(codec, m):
    flat = np.ascontiguousarray(m, np.float32).reshape(-1)
    payload, meta = codec.encode(flat)
    return payload, (flat.size,), meta


def test_train_with_an_inprocess_fleet_serves_the_keyframed_masters(tmp_path, monkeypatch):
    """train() builds the fleet and stops it in its finally. Just before
    the stop (hooked), once every replica serves the last epoch's keyframe,
    each replica's streams through the router's HTTP equal those of a
    ServeEngine given the trainer's masters through the state codec."""
    import opendiloco_torch.fleet as tfleet
    from opendiloco_torch.models.hf_io import load_config
    from opendiloco_torch.serve import ContinuousBatcher, ServeEngine
    from opendiloco_torch.train import train

    seen = {}
    real_stop = tfleet.FleetPlane.stop

    def stop(plane):
        try:
            epoch, masters = plane.publisher.snapshot_fn()
            seen["epoch"] = epoch
            seen["ready"] = wait(lambda: all(r.engine.weights_epoch == epoch for r in plane.replicas.values()), 60)
            seen["status"] = tfleet.status()
            # what a keyframe carries: each master through the state codec
            codec = plane.publisher.kf_codec
            seen["decoded"] = [np.asarray(codec.decode(*_encoded(codec, m)), np.float32).reshape(m.shape)
                               for m in masters]
            prompts = [[5, 6, 7, 8], [100, 200, 300, 400, 500, 600, 700, 800, 900]]
            seen["streams"] = {rid: [_generate(r.server.port, p, 8)["tokens"] for p in prompts]
                               for rid, r in plane.replicas.items()}
            seen["routed"] = [plane.router.dispatch({"prompt": p, "max_new_tokens": 8})["tokens"] for p in prompts]
            seen["prompts"] = prompts
        finally:
            real_stop(plane)

    monkeypatch.setattr(tfleet.FleetPlane, "stop", stop)
    backend = LoopbackWorld(1).make_backends()[0]
    summary = train(_train_config(tmp_path, keyframe_every=1), backend, device="cpu")
    assert summary["step"] == 8 and tfleet.status() == {"enabled": False}
    assert seen["epoch"] == 4 and seen["ready"]
    st = seen["status"]
    assert st["enabled"] and set(st["router"]["replicas"]) == {"r0", "r1"}
    assert all(v["keyframe_frames"] >= 1 for v in st["publisher"]["replicas"].values())
    cfg = load_config("2m")
    params = tllama.unflatten_params(tllama.init_params(torch.Generator().manual_seed(0), cfg),
                                     [torch.from_numpy(x) for x in seen["decoded"]])
    engine = ServeEngine(cfg, params, num_slots=2, max_context=64, prefill_buckets=[16, 32],
                         compute_dtype=torch.float32, device="cpu")
    batcher = ContinuousBatcher(engine).start()
    try:
        want = []
        for p in seen["prompts"]:
            r = batcher.submit(p, max_new_tokens=8)
            assert r.wait(60) and r.error is None
            want.append(list(r.tokens))
    finally:
        batcher.stop()
    assert seen["streams"] == {"r0": want, "r1": want}
    assert seen["routed"] == want


def test_the_fleet_rpc_answers_fleet_status(tmp_path):
    """The TCP backend's control port answers the "fleet" frame with
    fleet.status(): disabled without a plane, the plane's roll-up with
    one registered."""
    import opendiloco_torch.fleet as tfleet
    from opendiloco_torch.diloco.rendezvous import RendezvousServer
    from opendiloco_torch.diloco.tcp import TcpBackend
    from opendiloco_torch.fleet.wire import recv_frame, send_frame

    daemon = RendezvousServer("127.0.0.1", 0).start_in_thread()
    backend = TcpBackend([daemon.address], peer_id="worker-0", matchmaking_time=1.0)

    def rpc():
        with socket.create_connection((backend.host, backend.port), timeout=10) as s:
            send_frame(s, "fleet", {})
            return recv_frame(s, timeout=10.0)

    class _Plane:
        def status(self):
            return {"router": {"port": 1}, "publisher": {}, "manager": {}}

    try:
        assert rpc()[:2] == ("ok", {"enabled": False})
        tfleet.register_plane(_Plane())
        assert rpc()[:2] == ("ok", {"enabled": True, "router": {"port": 1}, "publisher": {}, "manager": {}})
    finally:
        tfleet.register_plane(None)
        backend.close()
        daemon.stop()
