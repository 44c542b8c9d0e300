"""The port's flight recorder, galaxy overseer and anomaly watchdogs.

The cases of ``tests/test_blackbox.py`` on the port's copies
(``opendiloco_torch/obs/blackbox.py``, ``overseer.py``, ``anomaly.py``):
zero cost when ``ODTP_OBS`` is unset, bounded rings, atomic dumps, the
signal hook, the overseer's roll-up and merge, every watchdog detector,
the clock alignment. Then the port's planes: a two-worker loopback
training run armed leaves a black box per worker at exit, and
``scripts/odtp_postmortem.py`` (the reference's tool) merges the port's
dumps into one round timeline.
"""

import importlib.util
import json
import os
import signal
import time
import tracemalloc

import pytest

from opendiloco_torch import obs
from opendiloco_torch.obs import anomaly, blackbox, export, overseer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_obs(monkeypatch):
    """Every test starts and ends with the obs plane disarmed."""
    for var in ("ODTP_OBS", "ODTP_OBS_DIR", "ODTP_OBS_PROM_PORT",
                "ODTP_OBS_EVENTS_CAP", "ODTP_OBS_BLACKBOX_CAP",
                "ODTP_OBS_BLACKBOX_FLUSH_S", "ODTP_WATCHDOG_STALL_S",
                "ODTP_WATCHDOG_STRAGGLER_X", "ODTP_WATCHDOG_DIVERGE_Z"):
        monkeypatch.delenv(var, raising=False)
    obs.reset()
    yield
    obs.reset()


def _arm(monkeypatch, tmp_path=None, **extra):
    monkeypatch.setenv("ODTP_OBS", "test")
    if tmp_path is not None:
        monkeypatch.setenv("ODTP_OBS_DIR", str(tmp_path))
    for k, v in extra.items():
        monkeypatch.setenv(k, str(v))


def _postmortem_mod():
    spec = importlib.util.spec_from_file_location(
        "odtp_postmortem", os.path.join(REPO, "scripts", "odtp_postmortem.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- zero-cost when disabled --------------------------------------------------


def test_disarmed_accessors_are_none():
    assert blackbox.recorder() is None
    assert overseer.plane() is None
    assert anomaly.watchdog() is None
    assert blackbox.install() is None  # convenience wrapper too


def test_disarmed_hook_sites_do_not_allocate():
    # the exact pattern every hook site uses: accessor + is-None branch
    for _ in range(10):  # warm caches first
        blackbox.recorder()
        overseer.plane()
        anomaly.watchdog()
    tracemalloc.start()
    before = tracemalloc.take_snapshot()
    for _ in range(1000):
        if blackbox.recorder() is not None:
            raise AssertionError("armed?")
        if overseer.plane() is not None:
            raise AssertionError("armed?")
        if anomaly.watchdog() is not None:
            raise AssertionError("armed?")
    after = tracemalloc.take_snapshot()
    tracemalloc.stop()
    grown = sum(
        d.size_diff for d in after.compare_to(before, "filename")
        if d.size_diff > 0
    )
    assert grown < 16 * 1024


# -- flight recorder ----------------------------------------------------------


def test_rings_are_bounded(monkeypatch):
    _arm(monkeypatch, ODTP_OBS_BLACKBOX_CAP=8)
    bb = blackbox.recorder()
    for i in range(50):
        bb.note_event({"name": f"e{i}", "ph": "i"})
    assert len(bb.events) == 8
    assert bb.events[-1]["name"] == "e49"
    for i in range(100):
        bb.note_fault("delay", "site", {"ms": i})
    assert len(bb.faults) == 100 if bb.faults.maxlen >= 100 else True
    assert len(bb.faults) == bb.faults.maxlen or len(bb.faults) == 100


def test_dump_shape_and_atomicity(monkeypatch, tmp_path):
    _arm(monkeypatch, tmp_path)
    tr = obs.tracer()
    tr.set_identity(worker=3)
    tr.gauge("inner_loss", 2.5)
    bb = blackbox.recorder()
    bb.note_event({"name": "outer/round", "ph": "i", "ts": 1.0,
                   "args": {"round": "grads-epoch-1"}})
    path = bb.dump(reason="test")
    assert path is not None and os.path.exists(path)
    assert os.path.basename(path) == f"blackbox-3-{os.getpid()}.json"
    # atomic: no tmp file left behind
    assert not [f for f in os.listdir(tmp_path) if ".tmp" in f]
    with open(path) as f:
        box = json.load(f)
    for key in ("version", "worker", "pid", "reason", "wall", "origin_wall",
                "identity", "dumps", "events", "health", "snapshots",
                "faults", "anomalies", "metrics", "galaxy"):
        assert key in box, key
    assert box["worker"] == 3
    assert box["reason"] == "test"
    rounds = [e for e in box["events"]
              if e.get("args", {}).get("round") == "grads-epoch-1"]
    assert rounds, box["events"]
    assert box["metrics"]["gauges"]["inner_loss"] == 2.5


def test_autodump_rate_limited_but_anomaly_dump_immediate(
        monkeypatch, tmp_path):
    _arm(monkeypatch, tmp_path, ODTP_OBS_BLACKBOX_FLUSH_S=3600)
    bb = blackbox.recorder()
    bb.note_health({"round": "grads-epoch-1"})   # first trigger dumps
    bb.note_health({"round": "grads-epoch-2"})   # within flush window: no
    assert bb.dumps == 1
    bb.note_anomaly({"kind": "stall"})           # watchdog trips bypass it
    assert bb.dumps == 2


def test_autodump_every_trigger_when_flush_zero(monkeypatch, tmp_path):
    _arm(monkeypatch, tmp_path, ODTP_OBS_BLACKBOX_FLUSH_S=0)
    bb = blackbox.recorder()
    for i in range(3):
        bb.note_health({"round": f"grads-epoch-{i}"})
    assert bb.dumps == 3


def test_no_dir_means_rings_accumulate_but_no_dump(monkeypatch):
    _arm(monkeypatch)  # no ODTP_OBS_DIR
    bb = blackbox.recorder()
    bb.note_health({"round": "r"})
    assert bb.dump() is None
    assert len(bb.health) == 1


def test_signal_hook_dumps_then_chains(monkeypatch, tmp_path):
    _arm(monkeypatch, tmp_path)
    seen = []
    prev = signal.signal(signal.SIGTERM, lambda s, f: seen.append(s))
    try:
        bb = blackbox.recorder()
        bb.install()
        os.kill(os.getpid(), signal.SIGTERM)
        deadline = time.time() + 5
        while not seen and time.time() < deadline:
            time.sleep(0.01)
        assert seen == [signal.SIGTERM]  # previous handler still ran
        assert bb.dumps >= 1
        with open(bb.path()) as f:
            assert json.load(f)["reason"] == f"signal:{int(signal.SIGTERM)}"
        bb.close()  # restores our lambda
        assert signal.getsignal(signal.SIGTERM) not in (
            bb._on_signal,)
    finally:
        signal.signal(signal.SIGTERM, prev)


# -- overseer -----------------------------------------------------------------


def test_rollup_carries_gauges_counters_and_round_health(monkeypatch):
    _arm(monkeypatch)
    tr = obs.tracer()
    tr.set_identity(worker=2)
    tr.gauge("inner_loss", 3.25)
    tr.gauge("inner_tokens_per_second", 1000.0)
    tr.count("wire_tx_bytes", 4096)
    ov = overseer.plane()
    ov.note_round({"round": "grads-epoch-2", "group_size": 4, "expected": 4,
                   "elastic": False, "retries": 0, "wire_s": 0.5,
                   "round_s": 2.0}, own_id="worker-2",
                  members=["worker-2"])
    roll = ov.rollup(capacity_bps=1e6)
    assert roll["v"] == overseer.HEALTH_VEC_VERSION
    assert roll["worker"] == 2
    assert roll["loss"] == 3.25
    assert roll["tokens_per_s"] == 1000.0
    assert roll["wire_tx"] == 4096
    assert roll["round"] == "grads-epoch-2"
    assert roll["group_size"] == 4
    assert roll["stages"] == {"wire_s": 0.5, "round_s": 2.0}
    assert roll["capacity_bps"] == 1e6
    assert roll["rounds"] == 1
    # note_round(own_id=...) put our own row in the matrix
    assert "worker-2" in ov.matrix()


def test_merge_is_version_and_staleness_gated(monkeypatch):
    _arm(monkeypatch)
    ov = overseer.plane()
    ov.merge("p", {"v": overseer.HEALTH_VEC_VERSION + 1, "ts": 99.0})
    assert "p" not in ov.matrix()  # future version dropped
    ov.merge("p", {"v": 1, "ts": 50.0, "loss": 1.0})
    ov.merge("p", {"v": 1, "ts": 40.0, "loss": 9.0})  # older: dropped
    assert ov.matrix()["p"]["loss"] == 1.0
    ov.merge("p", {"v": 1, "ts": 60.0, "loss": 0.5})  # newer: adopted
    assert ov.matrix()["p"]["loss"] == 0.5
    ov.merge("", {"v": 1, "ts": 70.0})       # no peer id
    ov.merge("q", "not-a-dict")              # malformed
    assert set(ov.matrix()) == {"p"}


def test_note_round_feeds_flight_recorder(monkeypatch, tmp_path):
    _arm(monkeypatch, tmp_path, ODTP_OBS_BLACKBOX_FLUSH_S=0)
    ov = overseer.plane()
    bb = blackbox.recorder()
    ov.note_round({"round": "grads-epoch-1", "group_size": 2,
                   "expected": 2, "elastic": False, "retries": 0})
    assert [h["round"] for h in bb.health] == ["grads-epoch-1"]
    assert bb.dumps == 1


# -- watchdogs ----------------------------------------------------------------


def _matrix(**per_peer):
    # straggler checks skip stale and first-round (compile warm-up)
    # roll-ups, so give every synthetic vector a fresh ts + warm rounds
    return {pid: {"ts": 1000.0, "rounds": 3, **vec}
            for pid, vec in per_peer.items()}


def test_straggler_by_round_time(monkeypatch):
    _arm(monkeypatch)
    wd = anomaly.watchdog()
    m = _matrix(
        a={"stages": {"round_s": 1.0}},
        b={"stages": {"round_s": 1.1}},
        c={"stages": {"round_s": 9.0}},
    )
    wd._check_straggler(m)
    tr = obs.tracer()
    assert tr.counters()[("anomaly_straggler", (("peer", "c"),))] == 1


def test_straggler_by_tokens_per_s(monkeypatch):
    _arm(monkeypatch, ODTP_WATCHDOG_STRAGGLER_X=1.5)
    wd = anomaly.watchdog()
    m = _matrix(
        a={"tokens_per_s": 1000.0},
        b={"tokens_per_s": 1050.0},
        c={"tokens_per_s": 980.0},
        d={"tokens_per_s": 400.0},  # < median / 1.5: the slow host
    )
    wd._check_straggler(m)
    tr = obs.tracer()
    assert tr.counters()[("anomaly_straggler", (("peer", "d"),))] == 1
    assert ("anomaly_straggler", (("peer", "a"),)) not in tr.counters()


def test_straggler_ignores_stale_and_warmup_rollups(monkeypatch):
    _arm(monkeypatch)
    wd = anomaly.watchdog()
    m = _matrix(
        a={"tokens_per_s": 1000.0},
        b={"tokens_per_s": 1050.0},
        c={"tokens_per_s": 980.0},
        # a departed worker's frozen vector: slow, but measured long ago
        dead={"tokens_per_s": 10.0, "ts": 100.0},
        # a compile-dominated first round is not a slow host
        fresh={"tokens_per_s": 10.0, "rounds": 1},
    )
    wd._check_straggler(m)
    assert not any(
        k[0] == "anomaly_straggler" for k in obs.tracer().counters())


def test_straggler_needs_three_reporters(monkeypatch):
    _arm(monkeypatch)
    wd = anomaly.watchdog()
    wd._check_straggler(_matrix(
        a={"stages": {"round_s": 1.0}}, b={"stages": {"round_s": 99.0}},
    ))
    assert not any(
        k[0].startswith("anomaly_") for k in obs.tracer().counters())


def test_divergence_z_score(monkeypatch):
    _arm(monkeypatch, ODTP_WATCHDOG_DIVERGE_Z=3.0)
    wd = anomaly.watchdog()
    m = _matrix(
        me={"pg_norm": 50.0},
        a={"pg_norm": 1.0}, b={"pg_norm": 1.1}, c={"pg_norm": 0.9},
    )
    wd._check_divergence({"round": "r"}, m, "me")
    tr = obs.tracer()
    assert tr.counters()[("anomaly_divergence", (("peer", "pg_norm"),))] == 1


def test_dead_peer_on_elastic_round_and_rearm(monkeypatch):
    _arm(monkeypatch)
    wd = anomaly.watchdog()
    full = {"round": "grads-epoch-1", "elastic": False}
    wd._check_dead_peers(full, ["a", "b", "c"])
    # b vanishes from an elastic round -> dead peer
    wd._check_dead_peers({"round": "grads-epoch-2", "elastic": True},
                         ["a", "c"])
    tr = obs.tracer()
    assert tr.counters()[("anomaly_dead_peer", (("peer", "b"),))] == 1
    # not reported again until it completes a round with us again
    wd._check_dead_peers({"round": "grads-epoch-3", "elastic": True},
                         ["a", "c"])
    assert tr.counters()[("anomaly_dead_peer", (("peer", "b"),))] == 1


def test_dead_peer_not_tripped_on_full_round(monkeypatch):
    _arm(monkeypatch)
    wd = anomaly.watchdog()
    wd._check_dead_peers({"round": "r1", "elastic": False}, ["a", "b"])
    # a SMALLER but non-elastic group (fresh expected size) is not a death
    wd._check_dead_peers({"round": "r2", "elastic": False}, ["a"])
    assert not any(
        k[0] == "anomaly_dead_peer" for k in obs.tracer().counters())


def test_serve_staleness_breach(monkeypatch):
    _arm(monkeypatch)
    wd = anomaly.watchdog()
    wd.serve_staleness(1.0, 4.0)  # within bound: quiet
    wd.serve_staleness(9.0, 4.0)  # breach
    tr = obs.tracer()
    assert tr.counters()[("anomaly_serve_staleness", ())] == 1


def test_trip_cooldown_per_subject(monkeypatch):
    _arm(monkeypatch)
    wd = anomaly.watchdog()
    assert wd._trip("straggler", subject="x") is True
    assert wd._trip("straggler", subject="x") is False  # cooldown
    assert wd._trip("straggler", subject="y") is True   # other subject
    tr = obs.tracer()
    assert tr.counters()[("anomaly_straggler", (("peer", "x"),))] == 1


def test_trip_dumps_blackbox_immediately(monkeypatch, tmp_path):
    _arm(monkeypatch, tmp_path)
    wd = anomaly.watchdog()
    bb = blackbox.recorder()
    wd._trip("stall", idle_s=99.0)
    assert bb.dumps == 1
    with open(bb.path()) as f:
        box = json.load(f)
    assert box["reason"] == "anomaly:stall"
    assert box["anomalies"][0]["kind"] == "stall"


def test_stall_watchdog_trips_and_rearms(monkeypatch):
    _arm(monkeypatch, ODTP_WATCHDOG_STALL_S=0.3)
    wd = anomaly.watchdog()
    wd.note_progress()
    assert wd._stall_thread is not None
    deadline = time.time() + 10
    while time.time() < deadline:
        tr = obs.tracer()
        if ("anomaly_stall", ()) in tr.counters():
            break
        time.sleep(0.05)
    assert obs.tracer().counters()[("anomaly_stall", ())] >= 1
    wd.close()
    assert wd._stall_thread is None


def test_stall_thread_not_started_when_disabled(monkeypatch):
    _arm(monkeypatch)  # default ODTP_WATCHDOG_STALL_S=0.0
    wd = anomaly.watchdog()
    wd.note_progress()
    assert wd._stall_thread is None


# -- tracer gauge -> Chrome counter track -------------------------------------


def test_gauge_records_counter_track_event(monkeypatch):
    _arm(monkeypatch)
    tr = obs.tracer()
    tr.gauge("outer_group_size", 4)
    tr.gauge("link_bps", 100.0, peer="w1")
    evs = [e for e in tr.events if e.get("ph") == "C"]
    assert [e["name"] for e in evs] == [
        "outer_group_size", "link_bps{peer=w1}"]
    assert evs[0]["args"]["value"] == 4
    chrome = export.chrome_trace([("w0", list(tr.events), {
        "origin_wall": 100.0})])
    c_rows = [e for e in chrome["traceEvents"] if e["ph"] == "C"]
    assert len(c_rows) == 2
    assert c_rows[0]["args"] == {"value": 4.0}


def test_events_mirror_into_flight_recorder(monkeypatch, tmp_path):
    _arm(monkeypatch, tmp_path, ODTP_OBS_BLACKBOX_CAP=4)
    tr = obs.tracer()
    for i in range(10):
        tr.instant("tick", i=i)
    bb = blackbox.recorder()
    assert len(bb.events) == 4  # ring-bounded even though tracer keeps all
    assert bb.events[-1]["args"]["i"] == 9


# -- cross-process clock alignment with skewed clocks -------------------------


def test_clock_shifts_align_deliberately_skewed_workers():
    # two workers observe the SAME physical instant; worker b's process
    # started 5 wall-clock seconds later, so its monotonic ts is 5s smaller
    ev_a = {"name": "outer/round", "ph": "i", "ts": 7_000_000.0, "args": {}}
    ev_b = {"name": "outer/round", "ph": "i", "ts": 2_000_000.0, "args": {}}
    workers = [
        ("a", [ev_a], {"origin_wall": 1000.0}),
        ("b", [ev_b], {"origin_wall": 1005.0}),
    ]
    t0, shifts = export.clock_shifts(workers)
    assert t0 == 1000.0
    assert shifts == [0.0, 5_000_000.0]
    wall_a = t0 + (ev_a["ts"] + shifts[0]) / 1e6
    wall_b = t0 + (ev_b["ts"] + shifts[1]) / 1e6
    assert wall_a == wall_b == 1007.0
    # the Chrome merge applies the same shift
    chrome = export.chrome_trace(workers)
    rows = [e for e in chrome["traceEvents"] if e["ph"] == "i"]
    assert rows[0]["ts"] == rows[1]["ts"] == 7_000_000.0


# -- the port's planes -------------------------------------------------------


def test_train_exit_dumps_merge_in_the_reference_postmortem(monkeypatch, tmp_path):
    """Two loopback workers of ``train()`` armed, on the CPU: each worker's
    exit dump (reason ``train_exit``) is written, and the reference's
    ``odtp_postmortem.py`` loads them and merges the round timeline, every
    outer round completed."""
    from test_torch_obs import run_train_workers

    _arm(monkeypatch, tmp_path)
    run_train_workers(2, steps=4, local_steps=2)
    boxes = _postmortem_mod().load_boxes(str(tmp_path))
    assert boxes and all(b["reason"] == "train_exit" for b in boxes)
    pm = _postmortem_mod().merge_postmortem(boxes)
    rounds = [r["round"] for r in pm["timeline"]]
    assert rounds == ["grads-epoch-0", "grads-epoch-1"]
    for row in pm["timeline"]:
        assert row["workers_partial"] == []
