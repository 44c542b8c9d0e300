"""The port's TCP galaxy against the JAX package's: copies and port-only
groups, on the CPU over real localhost sockets.

(a) The host-only copies (``opendiloco_torch/diloco/{schema,wire,planner,
linkstate,chaos}.py``) give the JAX package's frames byte for byte and its
plans, link estimates and chaos decisions value for value, on seeded
inputs.

(b) The patterns of ``tests/test_tcp_backend.py`` on groups of port
``TcpBackend``s, with the rendezvous daemon the port's
``RendezvousServer``, the JAX package's, and ``native/odtp-rendezvousd``
where it is built (decided in the fixture). Every all-reduce is held bit
for bit to a numpy model of the butterfly (each part folded in group
order from the peers' decoded contributions and the owner's raw one,
scaled by 1/n, then encoded once and adopted decoded by every peer), so
the mean is exact for every codec and the peers agree bit for bit.
"""
import asyncio
import dataclasses
import gc
import json
import os
import signal
import struct
import threading
import time
import weakref

import numpy as np
import pytest

from opendiloco_tpu.diloco import chaos as jchaos
from opendiloco_tpu.diloco import compression as jcomp
from opendiloco_tpu.diloco import linkstate as jlinkstate
from opendiloco_tpu.diloco import planner as jplanner
from opendiloco_tpu.diloco import schema as jschema
from opendiloco_tpu.diloco import wire as jwire
from opendiloco_tpu.diloco.rendezvous import RendezvousServer as JRendezvousServer
from opendiloco_torch import native
from opendiloco_torch.diloco import bulk, chaos, linkstate, planner, schema, wire
from opendiloco_torch.diloco import compression as tcomp
from opendiloco_torch.diloco.backend import PeerProgress
from opendiloco_torch.diloco.rendezvous import RendezvousServer
from opendiloco_torch.diloco.tcp import TcpBackend
from test_tcp_backend import _NATIVE_DAEMON, _NativeDaemon

CODECS = sorted(jcomp._CODECS)


# ---------------------------------------------------------------------------
# (a) the copies, byte for byte and value for value
# ---------------------------------------------------------------------------


def test_schema_constants_match():
    names = sorted(n for n in dir(jschema) if n.isupper())
    assert names == sorted(n for n in dir(schema) if n.isupper())
    for n in names:
        j, t = getattr(jschema, n), getattr(schema, n)
        if isinstance(j, struct.Struct):
            assert (t.format, t.size) == (j.format, j.size), n
        else:
            assert t == j, n


class _Writer:
    def __init__(self):
        self.out = bytearray()

    def write(self, b):
        self.out += bytes(b)

    async def drain(self):
        pass


def _frames():
    rng = np.random.default_rng(17)
    for k in range(6):
        meta = {
            "round": f"grads-epoch-{k}:{rng.integers(1 << 40):x}",
            "from": f"worker-{k % 3}",
            "meta": {"scale": float(rng.standard_normal()), "lo": -0.25, "span": 1.5},
            "shape": [int(rng.integers(1, 1 << 20))],
            **wire.chunk_fields(k, 6, 4096 * k, 4096),
        }
        yield ("push", "result", "ok", "join_group", "state", "probe")[k], meta, rng.bytes(int(rng.integers(0, 5000)))


def test_frames_match():
    """encode_frame and send_frame give the JAX bytes; each package's
    read_frame parses the other's."""

    async def run():
        for msg, meta, payload in _frames():
            enc = wire.encode_frame(msg, meta, payload)
            assert enc == jwire.encode_frame(msg, meta, payload)
            tw, jw = _Writer(), _Writer()
            await wire.send_frame(tw, msg, meta, payload)
            await jwire.send_frame(jw, msg, meta, payload)
            assert bytes(tw.out) == bytes(jw.out) == enc
            for read in (wire.read_frame, jwire.read_frame):
                reader = asyncio.StreamReader()
                reader.feed_data(enc)
                reader.feed_eof()
                assert await read(reader) == (msg, meta, payload)

    asyncio.run(run())
    rng = np.random.default_rng(5)
    blobs = [rng.bytes(int(n)) for n in rng.integers(0, 300, 5)]
    metas = [{"i": i} for i in range(5)]
    assert wire.pack_arrays(blobs, metas) == jwire.pack_arrays(blobs, metas)
    packed, pm = wire.pack_arrays(blobs, metas)
    assert wire.unpack_arrays(packed, pm) == jwire.unpack_arrays(packed, pm)
    for meta, size in (({"coff": 3, "clen": 4}, 7), ({}, 9), ({"coff": 5, "clen": 4}, 8)):
        got = [_outcome(m.chunk_span, meta, size) for m in (wire, jwire)]
        assert got[0] == got[1]
    for meta, want in (({"plan": "a"}, "a"), ({"plan": "a"}, "b"), ({}, "b"), ({"plan": "a"}, None)):
        assert _outcome(wire.check_plan, meta, want) == _outcome(jwire.check_plan, meta, want)


def _outcome(fn, *args):
    """fn's value, or its error's type name and text."""
    try:
        return ("ok", fn(*args))
    except Exception as e:
        return (type(e).__name__, str(e))


def _member(pid, links=None):
    m = {"peer_id": pid, "host": "127.0.0.1", "port": 1, "progress": {}}
    if links is not None:
        m["progress"]["links"] = {"v": linkstate.LINK_VEC_VERSION, "peers": links}
    return m


def _group(kind: str):
    rng = np.random.default_rng(len(kind))
    if kind == "flat":
        return [_member(f"worker-{i}") for i in range(3)]
    if kind == "adaptive":
        ids = [f"worker-{i}" for i in range(4)]
        return [_member(p, {o: {"bps": float(rng.uniform(1e7, 1e9)), "rtt_ms": float(rng.uniform(0.1, 50))}
                            for o in ids if o != p}) for p in ids]
    if kind == "one_without_links":
        group = _group("adaptive")
        group[2]["progress"].pop("links")
        return group
    ids = ["dc-a-0", "dc-a-1", "dc-a-2", "dc-b-0", "dc-b-1"]  # two sites
    return [_member(p, {o: {"bps": 1e9 if o[:4] == p[:4] else 5e7, "rtt_ms": 1.0} for o in ids if o != p})
            for p in ids]


PLANS = [("flat", False, {}), ("adaptive", True, {}), ("one_without_links", True, {}),
         ("two_dc", False, {"ODTP_HIER": "1"}), ("two_dc", True, {"ODTP_HIER": "1"}),
         ("two_dc", False, {"ODTP_HIER": "1", "ODTP_SITES": "dc-a-*;dc-b-*", "ODTP_HIER_AGG": "*-1"}),
         ("two_dc", True, {"ODTP_SITES": "dc-a-*;dc-b-*"})]


@pytest.mark.parametrize("kind,adaptive,env", PLANS, ids=lambda v: str(v))
def test_round_plans_match(kind, adaptive, env, monkeypatch):
    for k in ("ODTP_HIER", "ODTP_SITES", "ODTP_HIER_AGG"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    group = _group(kind)
    for total in (1, 7, 12345, 1 << 22):
        t = planner.plan_round(group, total, adaptive=adaptive)
        j = jplanner.plan_round(group, total, adaptive=adaptive)
        assert np.array_equal(t.bounds, j.bounds) and t.bounds.dtype == j.bounds.dtype
        assert (t.fingerprint, t.plan_meta, t.health, t.site_of) == (j.fingerprint, j.plan_meta, j.health,
                                                                       j.site_of)
        assert (t.hier is None) == (j.hier is None)
        if t.hier is not None:
            assert dataclasses.asdict(t.hier) == dataclasses.asdict(j.hier)
    assert planner.group_capacities(group) == jplanner.group_capacities(group)
    assert planner.cluster_sites(group) == jplanner.cluster_sites(group)
    caps = jplanner.group_capacities(group)
    if caps:
        assert planner.plan_shares(caps) == jplanner.plan_shares(caps)


def test_fragment_partitions_and_hashes_match():
    rng = np.random.default_rng(2)
    for _ in range(20):
        sizes = [int(s) for s in rng.integers(1, 10_000, int(rng.integers(1, 40)))]
        for n_frag in range(1, len(sizes) + 2):
            assert _outcome(planner.fragment_partition, sizes, n_frag) == _outcome(
                jplanner.fragment_partition, sizes, n_frag)
    for n in (1, 2, 3, 7):
        b = planner.uniform_bounds(1_000_003, n)
        assert np.array_equal(b, jplanner.uniform_bounds(1_000_003, n))
        assert planner.plan_hash(b) == jplanner.plan_hash(b)
        assert planner.shares_of(b, 1_000_003) == jplanner.shares_of(b, 1_000_003)


def test_link_estimates_match(monkeypatch):
    """The same seeded transfer timings give the same estimates and the
    same published vectors (hysteresis included)."""
    monkeypatch.delenv("ODTP_LINK_ALPHA", raising=False)
    monkeypatch.delenv("ODTP_LINK_HYST", raising=False)
    rng = np.random.default_rng(23)
    t, j = linkstate.LinkEstimator("worker-0"), jlinkstate.LinkEstimator("worker-0")
    peers = ["worker-1", "worker-2", "worker-3"]
    for step in range(300):
        pid = peers[int(rng.integers(len(peers)))]
        op = int(rng.integers(4))
        if op == 0:
            args = (pid, int(rng.integers(1, 1 << 26)), float(rng.uniform(1e-4, 2.0)))
            t.observe_send(*args), j.observe_send(*args)
        elif op == 1:
            args = (pid, float(rng.uniform(1e-5, 0.2)))
            t.observe_rtt(*args), j.observe_rtt(*args)
        elif op == 2:
            args = (pid, float(rng.uniform(1e6, 1e10)), float(rng.uniform(1e-4, 0.1)))
            t.seed(*args), j.seed(*args)
        else:
            assert t.publish() == j.publish()
            assert t.published_capacity() == j.published_capacity()
        for p in peers + ["worker-9"]:
            assert (t.bps_to(p), t.rtt_to(p), t.needs_probe(p)) == (j.bps_to(p), j.rtt_to(p), j.needs_probe(p))
    vec = j.publish()
    t.merge_remote("worker-5", vec), j.merge_remote("worker-5", vec)
    assert t.matrix() == j.matrix()
    for nbytes, bps, rtt, fallback, align in [(1 << 20, 1e9, 0.05, 1 << 21, 1), (1 << 30, 1e8, 0.2, 1 << 20, 4096),
                                              (512, 0.0, 0.0, 1024, 2), (1 << 26, 5e9, 1e-5, 1 << 21, 1)]:
        for streams in (1, 4):
            assert linkstate.hedge_deadline_s(nbytes, bps, rtt, streams) == jlinkstate.hedge_deadline_s(
                nbytes, bps, rtt, streams)
        assert linkstate.stripes_for(nbytes, bps, rtt) == jlinkstate.stripes_for(nbytes, bps, rtt)
        assert linkstate.chunk_elems_for(bps, rtt, fallback, align) == jlinkstate.chunk_elems_for(
            bps, rtt, fallback, align)


SPECS = [
    "seed=7;drop_conn=0.05;delay_ms=20..200;kill_worker=r3:w5;blackout_rdv=r2",
    "seed=3;truncate=0.3;drop_conn=0.2;delay_ms=5;delay_p=0.5;straggle_ms=5..9;straggle_worker=1",
    "seed=11;straggle_inner_ms=1..3;straggle_inner_x=w1:2.0,w3:4.0;egress_bps=1000000;wan_bps=5000;"
    "wan_peers=dc-a-*|x*",
    "seed=5;straggle_inner_x=3.0;workers=w1,w2;blackout_rdv=r1,r3;blackout_s=0.5;kill_worker=r1:w0,r2:w1",
    "drop_conn=1.5",
    "seed=1;bogus=3",
]


@pytest.mark.parametrize("spec", SPECS)
def test_chaos_specs_match(spec):
    """parse_spec, and every decision the plane draws, in the same order."""
    parsed = _outcome(chaos.parse_spec, spec)
    assert parsed == _outcome(jchaos.parse_spec, spec)
    if parsed[0] != "ok":
        return
    t, j = chaos.ChaosPlane(spec), jchaos.ChaosPlane(spec)
    t.set_identity(1), j.set_identity(1)
    for p in (t, j):
        p.seq = []
        for k in range(120):
            site = ("rdv_rpc", "peer_rpc", "bulk_send", "mailbox")[k % 4]
            p.seq += [p.drop_conn(site), p.truncate(site), p.delay_s(site), p.straggle_s(),
                      p.straggle_inner_s(), p.straggle_inner_x(k % 4), p.should_kill(k % 4, k % 6),
                      p.is_wan_peer(f"dc-a-{k % 3}"), p.is_wan_peer(f"worker-{k}")]
        p.seq += [p.egress_bps(), p.wan_bps(), p.kill_schedule(), p.straggle_inner_x()]
        p.seq += [p.rdv_blackout(f"grads-epoch-{r}") for r in range(4)]
    assert t.seq == j.seq
    assert dict(t.counters) == dict(j.counters) and t.events == j.events


@pytest.mark.parametrize("spec", [None, SPECS[0]])
def test_backoff_and_retries_match(spec, monkeypatch):
    for env in ("ODTP_RETRY_BASE_S", "ODTP_RETRY_CAP_S", "ODTP_ROUND_RETRIES"):
        monkeypatch.delenv(env, raising=False)
    if spec is None:
        monkeypatch.delenv("ODTP_CHAOS", raising=False)
        for attempt in range(8):  # unseeded jitter: within the same bounds
            span = min(15.0, 0.5 * 2 ** attempt)
            assert 0.5 * span <= chaos.backoff_s(attempt) <= span
    else:
        monkeypatch.setenv("ODTP_CHAOS", spec)
        chaos.reset(), jchaos.reset()
        assert [chaos.backoff_s(a) for a in range(8)] == [jchaos.backoff_s(a) for a in range(8)]
        chaos.reset(), jchaos.reset()
    monkeypatch.setenv("ODTP_ROUND_RETRIES", "5")
    assert chaos.round_retries() == jchaos.round_retries() == 5


# ---------------------------------------------------------------------------
# (b) port-only groups over real sockets
# ---------------------------------------------------------------------------


@pytest.fixture(params=["port", "jax", "native"])
def daemon(request):
    """The port's rendezvous daemon, the JAX package's, or the C++ one
    where it is built."""
    if request.param == "native":
        if not os.path.exists(_NATIVE_DAEMON):
            pytest.skip("native/odtp-rendezvousd is not built here (make -C native)")
        server = _NativeDaemon()
    else:
        cls = RendezvousServer if request.param == "port" else JRendezvousServer
        server = cls(host="127.0.0.1", port=0).start_in_thread()
    yield server
    server.stop()


def make_backends(address, n, cls=TcpBackend, **kwargs):
    kwargs.setdefault("matchmaking_time", 2.0)
    return [cls([address], peer_id=f"worker-{i}", **kwargs) for i in range(n)]


def concurrent_allreduce(backends, arrays_per_peer, timeout=60.0, **kw):
    results, errors = [None] * len(backends), []

    def run(i):
        try:
            out, group = backends[i].all_reduce(arrays_per_peer[i], timeout=timeout, **kw)
            results[i] = ([o.copy() for o in out], group)
        except Exception as e:
            errors.append((i, e))

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(backends))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout + 30)
    assert not errors, errors
    return results


def close_all(backends):
    for b in backends:
        b.close()


def butterfly(data, codec_name):
    """The averaged arrays every peer of a flat butterfly round ends with,
    computed here with the port's codec: peers in group order (the data's
    order), part j folded from peer j's raw part and the others' decoded
    pushes, scaled by 1/n, encoded once and adopted decoded."""
    n = len(data)
    codec = tcomp.get_codec(codec_name)
    flats = [np.concatenate([np.asarray(a, np.float32).reshape(-1) for a in d]) for d in data]
    bounds = planner.uniform_bounds(flats[0].size, n)
    out = np.empty_like(flats[0])
    for j in range(n):
        sl = slice(int(bounds[j]), int(bounds[j + 1]))
        acc = np.empty(sl.stop - sl.start, np.float32)
        for i in range(n):
            if i == j:
                if i == 0:
                    np.copyto(acc, flats[i][sl])
                else:
                    native.add_inplace(acc, flats[i][sl])
                continue
            payload, meta = codec.encode(flats[i][sl])
            (codec.decode_into if i == 0 else codec.decode_accumulate)(bytes(payload), meta, acc)
        native.scale_inplace(acc, 1.0 / n)
        payload, meta = codec.encode(acc)
        codec.decode_into(bytes(payload), meta, out[sl])
    res, off = [], 0
    for a in data[0]:
        res.append(out[off : off + a.size].reshape(a.shape))
        off += a.size
    return res


def random_data(n, seed):
    rng = np.random.default_rng(seed)
    shapes = [(1000,), (31, 9), (7,)]
    return [[rng.normal(scale=0.1, size=s).astype(np.float32) for s in shapes] for _ in range(n)]


def assert_rounds_equal(results, expected, n):
    for out, group in results:
        assert group == n
        for o, e in zip(out, expected):
            assert o.dtype == np.float32 and o.shape == e.shape
            np.testing.assert_array_equal(o.view(np.uint32), e.view(np.uint32))


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("n", [2, 3])
def test_allreduce_mean(daemon, n, codec):
    """The mean, exact to the butterfly model, bit-identical on every peer."""
    backends = make_backends(daemon.address, n, compression=codec)
    try:
        data = random_data(n, 7 + n)
        assert_rounds_equal(concurrent_allreduce(backends, data), butterfly(data, codec), n)
    finally:
        close_all(backends)


def test_register_and_progress(daemon):
    backends = make_backends(daemon.address, 2)
    try:
        for i, b in enumerate(backends):
            b.report_progress(PeerProgress(b.peer_id, epoch=i, samples=10 * i, samples_per_second=1.0,
                                           timestamp=time.time()))
        backends[0].report_progress(PeerProgress(backends[0].peer_id, 0, 0, 1.0, time.time()))
        assert {p.peer_id for p in backends[0].peer_progress()} == {"worker-0", "worker-1"}
        assert backends[0].num_peers() == 2
    finally:
        close_all(backends)


def test_allreduce_survives_peer_drop(daemon):
    """A registered peer that leaves delays the round by the matchmaking
    window only; the survivors average over the smaller group."""
    backends = make_backends(daemon.address, 3, matchmaking_time=1.0)
    try:
        backends[2].close()
        data = [[np.full(10, float(i + 1), np.float32)] for i in range(2)]
        for out, group in concurrent_allreduce(backends[:2], data, timeout=30.0):
            assert group == 2
            np.testing.assert_array_equal(out[0], np.full(10, 1.5, np.float32))
        assert backends[0].last_round_health["group_size"] == 2
    finally:
        close_all(backends[:2])


def test_single_peer_allreduce(daemon):
    (b,) = make_backends(daemon.address, 1, matchmaking_time=0.5)
    try:
        out, group = b.all_reduce([np.arange(5, dtype=np.float32)], timeout=20.0)
        assert group == 1
        np.testing.assert_array_equal(out[0], np.arange(5))
    finally:
        b.close()


def test_fetch_state_from_peer(daemon, monkeypatch):
    monkeypatch.setenv("ODTP_STATE_CODEC", "none")
    backends = make_backends(daemon.address, 2)
    try:
        rng = np.random.default_rng(4)
        served = {"master": [rng.standard_normal((3, 5)).astype(np.float32), np.arange(4, dtype=np.float32)],
                  "epoch": 3, "outer_opt": {"lr": 0.7, "momentum": 0.9, "nesterov": True, "bufs": None}}
        backends[0].serve_state(lambda: served)
        backends[0].report_progress(PeerProgress(backends[0].peer_id, 3, 0, 1.0, time.time()))
        got = backends[1].fetch_state()
        assert got is not None and got["epoch"] == 3 and got["outer_opt"] == served["outer_opt"]
        for a, b in zip(got["master"], served["master"]):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    finally:
        close_all(backends)


def test_group_cap_partitions_into_pairs(daemon):
    """group_cap=2: four peers form two disjoint pairs, each averaging
    only its own inputs."""
    backends = make_backends(daemon.address, 4)
    try:
        data = [[np.full(16, float(i + 1), np.float32)] for i in range(4)]
        results = concurrent_allreduce(backends, data, epoch=0, group_cap=2)
        partners = {}
        for i, (out, group) in enumerate(results):
            assert group == 2
            partners[i + 1] = round(float(out[0][0] * 2 - (i + 1)))
        assert all(partners[partners[v]] == v for v in partners)
        assert sorted(partners) == [1, 2, 3, 4]
    finally:
        close_all(backends)


def test_rendezvous_failover_allreduce():
    """Two daemons; the first dies after the group forms, and both workers
    fail over to the second in lockstep. Both declare the galaxy's size
    (``expect_peers``): the second daemon learns each worker only when it
    fails over, and without it the first to arrive may close the round
    alone by the every-live-peer rule (the JAX package's copy of this
    test, which leaves it out, comes and goes on that)."""
    primary = RendezvousServer(host="127.0.0.1", port=0).start_in_thread()
    secondary = RendezvousServer(host="127.0.0.1", port=0).start_in_thread()
    backends = [TcpBackend([primary.address, secondary.address], peer_id=f"worker-{i}", matchmaking_time=1.0,
                           rpc_timeout=5.0, expect_peers=2) for i in range(2)]
    try:
        data = [[np.full(8, float(i + 1), np.float32)] for i in range(2)]
        for out, group in concurrent_allreduce(backends, data, timeout=30.0):
            assert group == 2 and np.array_equal(out[0], np.full(8, 1.5, np.float32))
        primary.stop()
        for out, group in concurrent_allreduce(backends, data, timeout=60.0):
            assert group == 2 and np.array_equal(out[0], np.full(8, 1.5, np.float32))
        assert backends[0].rendezvous == backends[1].rendezvous == tuple(
            (h, int(p)) for h, p in [secondary.address.rsplit(":", 1)])[0]
    finally:
        close_all(backends)
        secondary.stop()


def test_all_daemons_die_swarm_reforms_on_worker_rendezvous(daemon):
    """Every daemon dies mid-run: the workers re-form on the lowest peer
    id's embedded rendezvous and the next round still averages over both,
    never a solo split; the worker-hosted address never enters the daemon
    membership they gossip. Both declare the galaxy's size, as in the
    failover test above."""
    backends = make_backends(daemon.address, 2, rpc_timeout=5.0, expect_peers=2)
    try:
        for b in backends:
            b.report_progress(PeerProgress(b.peer_id, 0, 0, 0.0, time.time()))
        data = [[np.full(8, float(i + 1), np.float32)] for i in range(2)]
        for out, group in concurrent_allreduce(backends, data):
            assert group == 2 and np.array_equal(out[0], np.full(8, 1.5, np.float32))
        if isinstance(daemon, _NativeDaemon):
            daemon.proc.send_signal(signal.SIGKILL)
            daemon.proc.wait(timeout=5)
        else:
            daemon.stop()
        for out, group in concurrent_allreduce(backends, data, timeout=120.0):
            assert group == 2 and np.array_equal(out[0], np.full(8, 1.5, np.float32))
        current = {b.rendezvous for b in backends}
        embedded = {("127.0.0.1", b._rdv_fallback.port) for b in backends}
        assert len(current) == 1 and current <= embedded
        for b in backends:
            known = b._register_meta()["known_daemons"]
            assert not any(f"{h}:{p}" in known for h, p in embedded)
    finally:
        close_all(backends)


def test_closed_backends_are_released(daemon):
    """After a round and ``close`` nothing keeps a backend (and so the
    state its provider holds) alive: its threads end, the bulk plane's
    accept thread too, and its round buffers go."""
    backends = make_backends(daemon.address, 2)
    concurrent_allreduce(backends, random_data(2, 5))
    refs = [weakref.ref(b) for b in backends]
    threads = [t for b in backends for t in (b._thread, b._bulk_server._accept_thread)]
    close_all(backends)
    assert all(not b._free_bufs and not b._retired_bufs for b in backends)
    del backends
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive(), t.name
    del threads
    gc.collect()
    assert all(r() is None for r in refs)


# -- the bulk data plane ------------------------------------------------------


@pytest.mark.parametrize("path", ["large", "striped", "disabled"])
def test_bulk_plane_paths_allreduce(path, monkeypatch):
    """Large frames over the threaded bulk plane (threshold 1: every part),
    striped over three streams (the serial whole-part path), and the bulk
    plane off (every frame over the asyncio RPC path): the round is exact
    each way, and the frames the bulk plane saw say which path ran."""
    env = {"large": {"ODTP_BULK_THRESHOLD": "1"},
           "striped": {"ODTP_PIPELINE": "0", "ODTP_BULK_THRESHOLD": "1", "ODTP_BULK_STREAMS": "3",
                       "ODTP_BULK_STRIPE_MIN": "64"},
           "disabled": {"ODTP_BULK_THRESHOLD": "0"}}[path]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    seen = []
    monkeypatch.setattr(bulk, "_frame_observer", seen.append)
    server = RendezvousServer(host="127.0.0.1", port=0).start_in_thread()
    backends = make_backends(server.address, 2, matchmaking_time=1.0, compression="uniform8bit")
    try:
        data = random_data(2, 3)
        assert_rounds_equal(concurrent_allreduce(backends, data, timeout=30.0), butterfly(data, "uniform8bit"), 2)
        if path == "disabled":
            assert all(b._bulk_server is None for b in backends) and not seen
        else:
            assert "push" in seen and "result" in seen
            assert ("_stripe" in seen) == (path == "striped")
    finally:
        close_all(backends)
        server.stop()


def test_bulk_striped_transfer_roundtrip(monkeypatch):
    """Frames above the stripe floor split over parallel streams and
    reassemble into one buffer byte for byte; small ones stay single."""
    monkeypatch.setenv("ODTP_BULK_STREAMS", "3")
    monkeypatch.setenv("ODTP_BULK_STRIPE_MIN", "1024")
    got, done = [], threading.Event()

    def deliver(msg, meta, payload):
        got.append((msg, meta, payload.copy()))
        done.set()

    server, sender = bulk.BulkServer(deliver, host="127.0.0.1"), bulk.BulkSender()
    try:
        rng = np.random.default_rng(3)
        data = rng.integers(0, 255, 1_000_003, np.uint8)
        sender.send("127.0.0.1", server.port, "push", {"k": 1}, data)
        assert done.wait(20.0)
        assert got[0][:2] == ("push", {"k": 1}) and np.array_equal(got[0][2], data)
        done.clear()
        small = rng.integers(0, 255, 64, np.uint8)
        sender.send("127.0.0.1", server.port, "push", {"k": 2}, small)
        assert done.wait(20.0) and np.array_equal(got[1][2], small)
    finally:
        sender.close()
        server.stop()


def test_bulk_bandwidth_cap_shapes_egress(monkeypatch):
    """ODTP_BULK_BANDWIDTH_BPS caps the payload egress: 8 MB at 32 MB/s
    takes at least the bucket's time less its burst, and arrives exact."""
    got, done = [], threading.Event()

    def deliver(msg, meta, payload):
        got.append(payload.copy())
        done.set()

    server, sender = bulk.BulkServer(deliver, host="127.0.0.1"), bulk.BulkSender()
    try:
        data = np.random.default_rng(5).integers(0, 255, 8 << 20, np.uint8)
        sender.send("127.0.0.1", server.port, "push", {}, data)
        assert done.wait(20.0)
        done.clear()
        monkeypatch.setenv("ODTP_BULK_BANDWIDTH_BPS", str(32 << 20))
        t0 = time.perf_counter()
        sender.send("127.0.0.1", server.port, "push", {}, data)
        assert done.wait(30.0)
        assert time.perf_counter() - t0 > 0.12
        assert np.array_equal(got[1], data)
        monkeypatch.delenv("ODTP_BULK_BANDWIDTH_BPS")
        assert bulk.egress_bucket() is None
    finally:
        sender.close()
        server.stop()


def test_round_health_records_stage_times(daemon):
    """Each round's health row carries the group and its stage times:
    matchmaking, scatter-reduce, gather and the per-stage encode /
    accumulate / wire seconds."""
    backends = make_backends(daemon.address, 2, compression="fp16")
    try:
        concurrent_allreduce(backends, random_data(2, 1))
        for b in backends:
            h = b.last_round_health
            assert h["group_size"] == 2 and h["retries"] == 0 and not h["elastic"]
            for key in ("matchmake_s", "flatten_s", "scatter_reduce_s", "all_gather_s", "round_s", "encode_s",
                        "accumulate_s", "wire_send_s", "wire_recv_s"):
                assert h[key] >= 0.0, key
            assert b.round_ledger[-1] is h
            json.dumps(h)
    finally:
        close_all(backends)
