"""The obs plane across the port's TCP galaxy and gossip, against the JAX
package's, on the CPU.

Both packages are armed by the same env knobs (``ODTP_OBS``) and each has
its own tracer, overseer, ring, recorder and watchdog, so one process
holds both planes:

- an all-JAX and an all-port galaxy (two ``TcpBackend`` workers each over
  their own package's daemon, the bulk plane on) run the same numpy arrays
  for two rounds and one state fetch, codecs none and uniform8bit: every
  counter (names, labels, values) is equal exactly, since the two wires
  are the same bytes; span names, gauge names and Prometheus families are
  equal as sets;
- a mixed galaxy (one JAX worker, one port worker): each side's
  ``health`` RPC answers a matrix with both workers' rows, and the JAX
  client's ``metrics`` and ``reqtrace`` RPCs to the port worker answer the
  armed bodies in the JAX schema; unarmed they answer the obs-off bodies;
- a chaos straggle injected on port workers lands in the port's flight
  recorder; an elastic round over TCP trips the port's dead-peer watchdog;
- a gossip pair round in both packages gives the same
  ``record_wire("gossip")`` and round counters, and the overseer's
  ``note_round`` row;
- unarmed, the new hook sites retain nothing.
"""
import asyncio
import time
import tracemalloc

import numpy as np
import pytest

from opendiloco_tpu import obs as jobs
from opendiloco_tpu.diloco import gossip as jgossip
from opendiloco_tpu.diloco import wire as jwire
from opendiloco_tpu.diloco.loopback import LoopbackWorld as JLoopbackWorld
from opendiloco_tpu.diloco.rendezvous import RendezvousServer as JRendezvousServer
from opendiloco_tpu.diloco.tcp import TcpBackend as JTcpBackend
from opendiloco_torch import obs
from opendiloco_torch.diloco import chaos
from opendiloco_torch.diloco import gossip as tgossip
from opendiloco_torch.diloco.backend import PeerProgress
from opendiloco_torch.diloco.compression import record_wire
from opendiloco_torch.diloco.loopback import LoopbackWorld
from opendiloco_torch.diloco.rendezvous import RendezvousServer
from opendiloco_torch.diloco.tcp import TcpBackend
from opendiloco_torch.obs import export
from test_torch_gossip import _inputs, run_pair
from test_torch_obs import _PROM_LINE, OBS_ENV, _families
from test_torch_tcp import close_all, concurrent_allreduce, random_data

# the counters the outer backend's per-layer metrics read
GALAXY_COUNTERS = {"rdv_rpcs", "rdv_frames", "rdv_rounds_closed", "peer_frames", "bulk_tx_bytes", "bulk_rx_bytes",
                   "outer_raw_bytes", "outer_wire_bytes", "fetch_state_calls"}


def _reset_both():
    obs.reset()
    jobs.reset()
    chaos.reset()


@pytest.fixture(autouse=True)
def _clean_obs(monkeypatch):
    """Both packages' planes start and end disarmed; the bulk plane takes
    every frame, and state fetches move raw f32."""
    for var in OBS_ENV + ("ODTP_CHAOS", "ODTP_EXPECT_PEERS"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("ODTP_BULK_THRESHOLD", "1")
    monkeypatch.setenv("ODTP_STATE_CODEC", "none")
    _reset_both()
    yield
    _reset_both()


def _arm(monkeypatch):
    monkeypatch.setenv("ODTP_OBS", "test")


def _rpc(backend, msg, meta=None):
    """One control RPC from the JAX package's client to a worker."""
    return asyncio.run(jwire.request(backend.host, backend.port, msg, meta or {}, timeout=10.0))


def _run_galaxy(server_cls, backend_cls, codec):
    """Two workers, two rounds of the same arrays, then worker 1 fetches
    worker 0's state."""
    daemon = server_cls(host="127.0.0.1", port=0).start_in_thread()
    backends = [backend_cls([daemon.address], peer_id=f"worker-{i}", matchmaking_time=2.0, compression=codec,
                            expect_peers=2) for i in range(2)]
    try:
        data = random_data(2, 17)
        for epoch in range(2):
            concurrent_allreduce(backends, data, epoch=epoch)
        served = {"master": [np.arange(12, dtype=np.float32)], "epoch": 2}
        backends[0].serve_state(lambda: served)
        backends[0].report_progress(PeerProgress(backends[0].peer_id, 2, 0, 1.0, time.time()))
        assert backends[1].fetch_state()["epoch"] == 2
        ledgers = [list(b.round_ledger) for b in backends]
    finally:
        close_all(backends)
        daemon.stop()
    return ledgers


def _names(tr, ph):
    return {e["name"] for e in tr.events if e.get("ph") == ph}


@pytest.mark.parametrize("codec", ["none", "uniform8bit"])
def test_port_and_jax_galaxies_report_the_same_counters(monkeypatch, codec):
    _arm(monkeypatch)
    _run_galaxy(JRendezvousServer, JTcpBackend, codec)
    ledgers = _run_galaxy(RendezvousServer, TcpBackend, codec)
    jtr, tr = jobs.tracer(), obs.tracer()
    counters, jcounters = tr.counters(), jtr.counters()
    assert counters == jcounters
    assert GALAXY_COUNTERS <= {name for name, _ in counters}
    # the codec's bytes follow the round ledger: in each round every worker
    # encodes the part it pushes, so two workers encode the whole f32
    # vector once a round; uniform8bit sends one byte an element
    rounds = len(ledgers[0])
    raw = 4 * sum(a.size for a in random_data(1, 0)[0]) * rounds
    assert rounds == 2 and counters[("outer_raw_bytes", (("codec", codec),))] == raw
    assert counters[("outer_wire_bytes", (("codec", codec),))] == (raw if codec == "none" else raw // 4)
    assert _names(tr, "X") == _names(jtr, "X")
    assert {"rdv/join_group", "outer/rendezvous", "outer/scatter_reduce", "outer/all_gather"} <= _names(tr, "X")
    assert {k for k in tr._gauges} == {k for k in jtr._gauges}
    assert _families(export.prometheus_text(tr)) == _families(jobs.export.prometheus_text(jtr))


def _mixed_galaxy(daemon):
    """One JAX worker and one port worker; both announce progress and run
    one round together."""
    backends = [JTcpBackend([daemon.address], peer_id="worker-0", matchmaking_time=2.0, expect_peers=2),
                TcpBackend([daemon.address], peer_id="worker-1", matchmaking_time=2.0, expect_peers=2)]
    for b in backends:
        b.report_progress(PeerProgress(b.peer_id, 0, 0, 1.0, time.time()))
    concurrent_allreduce(backends, random_data(2, 23))
    return backends


def test_mixed_galaxy_health_metrics_and_reqtrace_rpcs(monkeypatch):
    _arm(monkeypatch)
    daemon = RendezvousServer(host="127.0.0.1", port=0).start_in_thread()
    backends = _mixed_galaxy(daemon)
    try:
        for b in backends:
            msg, meta, _ = _rpc(b, "health")
            assert msg == "ok" and {"worker-0", "worker-1"} <= set(meta["matrix"])
        jax_worker, port_worker = backends
        msg, meta, body = _rpc(port_worker, "metrics")
        assert msg == "ok" and meta == {"format": "prometheus-0.0.4"}
        text = body.decode()
        for line in text.rstrip("\n").splitlines():
            assert _PROM_LINE.match(line), f"unlintable line: {line!r}"
        assert {"odtp_outer_rounds", "odtp_rdv_rpcs", "odtp_peer_frames"} <= _families(text)
        answers = {}
        for b in backends:
            msg, meta, _ = _rpc(b, "reqtrace", {"recent": 8})
            assert msg == "ok"
            answers[b.peer_id] = meta["reqtrace"]
        snap, jsnap = answers["worker-1"], answers["worker-0"]
        assert snap is not None and set(snap) == set(jsnap) == {"report", "inflight", "recent"}
        assert set(snap["report"]) == set(jsnap["report"])
    finally:
        close_all(backends)
        daemon.stop()


def test_unarmed_rpcs_answer_the_obs_off_bodies():
    daemon = JRendezvousServer(host="127.0.0.1", port=0).start_in_thread()
    backends = _mixed_galaxy(daemon)
    try:
        for b in backends:
            assert _rpc(b, "metrics")[2] == b""
            assert _rpc(b, "health")[1] == {"matrix": {}}
            assert _rpc(b, "reqtrace")[1] == {"reqtrace": None}
        assert obs.tracer() is None and obs.overseer.plane() is None
    finally:
        close_all(backends)
        daemon.stop()


def test_chaos_straggle_lands_in_the_port_flight_recorder(monkeypatch):
    _arm(monkeypatch)
    monkeypatch.setenv("ODTP_CHAOS", "seed=3;straggle_ms=5")
    chaos.reset()
    daemon = RendezvousServer(host="127.0.0.1", port=0).start_in_thread()
    backends = [TcpBackend([daemon.address], peer_id=f"worker-{i}", matchmaking_time=2.0, expect_peers=2)
                for i in range(2)]
    try:
        concurrent_allreduce(backends, random_data(2, 29))
    finally:
        close_all(backends)
        daemon.stop()
    faults = list(obs.blackbox.recorder().faults)
    assert faults and all(f["kind"] == "straggle" for f in faults)
    assert len(faults) == chaos.plane().counters["straggle"]
    assert not jobs.blackbox.recorder().faults


def test_elastic_round_trips_the_dead_peer_watchdog(monkeypatch):
    """Three workers finish a round; worker-2 stays registered but skips
    the next one, which closes elastic: the survivors' watchdog reports it
    dead, once."""
    _arm(monkeypatch)
    daemon = RendezvousServer(host="127.0.0.1", port=0).start_in_thread()
    backends = [TcpBackend([daemon.address], peer_id=f"worker-{i}", matchmaking_time=1.0, expect_peers=3)
                for i in range(3)]
    try:
        data = random_data(3, 31)
        concurrent_allreduce(backends, data, epoch=0)
        concurrent_allreduce(backends[:2], data[:2], epoch=1)
        assert all(b.last_round_health["elastic"] for b in backends[:2])
    finally:
        close_all(backends)
        daemon.stop()
    counters = obs.tracer().counters()
    assert counters[("anomaly_dead_peer", (("peer", "worker-2"),))] == 1
    trips = [a for a in obs.blackbox.recorder().anomalies if a["kind"] == "dead_peer"]
    assert [a["subject"] for a in trips] == ["worker-2"]


@pytest.mark.parametrize("compression", ["none", "blockwise4bit"])
def test_gossip_pair_round_counters_equal_the_reference(monkeypatch, compression):
    _arm(monkeypatch)
    inputs = _inputs()
    backends = LoopbackWorld(2).make_backends()
    out = run_pair([tgossip.GossipPlane(b, 2, compression=compression) for b in backends], inputs)
    jout = run_pair([jgossip.GossipPlane(b, 2, compression=compression)
                     for b in JLoopbackWorld(2).make_backends()], inputs)
    assert [o[4] for o in out] == [o[4] for o in jout] == [2, 2]
    tr, jtr = obs.tracer(), jobs.tracer()
    counters = tr.counters()
    assert counters == jtr.counters()
    wire = sum(b.last_round_health["wire_bytes"] for b in backends)
    assert counters[("outer_wire_bytes", (("codec", "gossip"),))] == wire
    assert counters[("gossip_wire_bytes", ())] == wire
    assert counters[("gossip_pair_rounds", ())] == 2
    assert _names(tr, "X") == _names(jtr, "X") == {"outer/gossip_pair"}
    rows = obs.overseer.plane().matrix()
    assert {b.peer_id for b in backends} <= set(rows)


def test_unarmed_galaxy_hook_sites_do_not_allocate():
    """The hook sites of the galaxy, gossip and fleet modules (counters,
    gauges, ``record_wire``, the tracer, overseer, ring, watchdog and
    recorder lookups with their None branch) retain nothing unarmed."""

    def hooks():
        obs.count("rdv_frames", msg="join_group")
        obs.count("bulk_tx_bytes", 4096)
        obs.count("fleet_push_frames", kind="delta", replica="r0")
        obs.gauge("fleet_replicas_live", 2)
        record_wire("gossip", 64, 32)
        if obs.tracer() is not None or obs.overseer.plane() is not None:
            raise AssertionError("armed?")
        if obs.reqtrace.ring() is not None or obs.anomaly.watchdog() is not None:
            raise AssertionError("armed?")
        if obs.blackbox.recorder() is not None:
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


def test_unarmed_galaxy_rounds_leave_no_obs_state():
    """A whole unarmed round and state fetch build no tracer, overseer or
    recorder, and the round's health still carries its stage times."""
    ledgers = _run_galaxy(RendezvousServer, TcpBackend, "uniform8bit")
    assert obs.tracer() is None and obs.overseer.plane() is None and obs.blackbox.recorder() is None
    for led in ledgers:
        assert len(led) == 2
        assert all({"encode_s", "wire_send_s", "wire_recv_s", "accumulate_s"} <= set(h) for h in led)
