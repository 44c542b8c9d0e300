"""The port's fleet autoscaler and manager, on the CPU.

The cases of ``tests/test_autoscale.py`` on the port's
``fleet/autoscaler.py``, over the reference suite's fake router and
manager: hysteresis, cooldown, bounds, spares before cold boots,
demotion, replacement of the dead outside the cooldown, the spare pool,
worst-replica aggregation, env overrides, the decision log and the loop
thread. Each drives ``evaluate()`` directly; where a boot lands on a
background thread the wait is bounded at 10 s. A scripted run gives the
JAX autoscaler's decisions, tick for tick. Then the port's real
``FleetManager`` (spares, promotion, demotion, the health matrix) and
``build_fleet`` with an autoscaler that replaces a dead in-process
replica by promoting a warm spare.
"""
from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from opendiloco_tpu.fleet.autoscaler import FleetAutoscaler as JFleetAutoscaler
from opendiloco_torch.fleet.autoscaler import FleetAutoscaler
from test_autoscale import FakeManager, FakeRouter, _load

torch.set_num_threads(2)


def _until(pred, t=10.0):
    deadline = time.monotonic() + t
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return pred()


def _fleet(cls=FleetAutoscaler):
    router = FakeRouter()
    manager = FakeManager(router)
    boots: list = []

    def boot(rid, register):
        boots.append((rid, register))
        manager.attach(rid, "127.0.0.1", 9000 + len(boots), "127.0.0.1", 0, router_register=register)
        if not register:
            manager._ready.add(rid)  # spares keyframe at once in the fake

    def scaler(**kw):
        for k, v in dict(slo_p99_ms=100.0, slo_queue_depth=8, min_replicas=1, max_replicas=4, cooldown_s=0.0,
                         up_evals=1, down_evals=1, boot_fn=boot, retire_fn=manager.detach).items():
            kw.setdefault(k, v)
        return cls(manager, router, **kw)

    class F:
        pass

    f = F()
    f.router, f.manager, f.boots, f.scaler = router, manager, boots, scaler
    return f


@pytest.fixture()
def fleet():
    return _fleet()


def test_scale_up_needs_consecutive_breaches(fleet):
    fleet.manager.attach("r0", "h", 1, "h", 2)
    a = fleet.scaler(up_evals=3)
    _load(fleet, "r0", p99_ms=500.0)
    assert a.evaluate() == [] and a.evaluate() == []
    made = a.evaluate()
    assert [d["action"] for d in made] == ["scale_up"] and made[0]["mode"] == "cold_boot"
    assert _until(lambda: len(fleet.router.replicas) == 2)
    _load(fleet, "r0", p99_ms=10.0, depth=0)
    a2 = fleet.scaler(up_evals=2)
    _load(fleet, "r0", p99_ms=500.0)
    a2.evaluate()
    _load(fleet, "r0", p99_ms=10.0)
    a2.evaluate()
    _load(fleet, "r0", p99_ms=500.0)
    assert a2.evaluate() == []  # the streak restarted


def test_queue_depth_alone_breaches(fleet):
    fleet.manager.attach("r0", "h", 1, "h", 2)
    a = fleet.scaler(slo_p99_ms=0.0)
    _load(fleet, "r0", p99_ms=None, depth=50)
    assert [d["action"] for d in a.evaluate()] == ["scale_up"]


def test_cooldown_spaces_actions(fleet):
    fleet.manager.attach("r0", "h", 1, "h", 2)
    a = fleet.scaler(cooldown_s=3600.0)
    _load(fleet, "r0", p99_ms=500.0)
    assert [d["action"] for d in a.evaluate()] == ["scale_up"]
    for _ in range(5):
        assert a.evaluate() == []
    assert _until(lambda: len(fleet.router.replicas) == 2)


def test_max_replicas_bounds_growth(fleet):
    fleet.manager.attach("r0", "h", 1, "h", 2)
    a = fleet.scaler(max_replicas=2)
    _load(fleet, "r0", p99_ms=500.0)
    a.evaluate()
    assert _until(lambda: len(fleet.router.replicas) == 2)
    assert a.evaluate() == [] and len(fleet.router.replicas) == 2


def test_spare_promotion_preferred_over_cold_boot(fleet):
    fleet.manager.attach("r0", "h", 1, "h", 2)
    fleet.manager.attach("s1", "h", 3, "h", 4, router_register=False)
    fleet.manager._ready.add("s1")
    a = fleet.scaler()
    _load(fleet, "r0", p99_ms=500.0)
    up = [d for d in a.evaluate() if d["action"] == "scale_up"]
    assert up and up[0]["mode"] == "spare_promotion" and up[0]["replica"] == "s1"
    assert "s1" in fleet.router.replicas and fleet.manager.spares() == []


def test_unready_spare_not_promoted(fleet):
    fleet.manager.attach("r0", "h", 1, "h", 2)
    fleet.manager.attach("s1", "h", 3, "h", 4, router_register=False)
    a = fleet.scaler(warm_spares=1)
    _load(fleet, "r0", p99_ms=500.0)
    up = [d for d in a.evaluate() if d["action"] == "scale_up"]
    assert up and up[0]["mode"] == "cold_boot" and "s1" not in fleet.router.replicas


def test_scale_down_demotes_or_retires_within_the_floor(fleet):
    for i in range(3):
        fleet.manager.attach(f"r{i}", "h", i, "h", 10 + i)
        _load(fleet, f"r{i}", p99_ms=5.0, depth=0)
    a = fleet.scaler(warm_spares=1, down_evals=2)
    assert [d["action"] for d in a.evaluate()] == ["boot_spare"]
    down = [d for d in a.evaluate() if d["action"] == "scale_down"]
    assert down and down[0]["mode"] == "demote_to_spare" and len(fleet.router.replicas) == 2
    assert down[0]["replica"] in fleet.manager.spares()
    f = _fleet()
    for i in range(2):
        f.manager.attach(f"r{i}", "h", i, "h", 10 + i)
        _load(f, f"r{i}", p99_ms=5.0, depth=0)
    down = [d for d in f.scaler(warm_spares=0).evaluate() if d["action"] == "scale_down"]
    assert down and down[0]["mode"] == "retire" and f.manager.detached == [down[0]["replica"]]
    a = f.scaler(min_replicas=1)
    for _ in range(5):
        assert a.evaluate() == []
    assert len(f.router.replicas) == 1


def test_dead_replica_replaced_outside_cooldown(fleet):
    fleet.manager.attach("r0", "h", 1, "h", 2)
    fleet.manager.attach("r1", "h", 3, "h", 4)
    fleet.manager.attach("s1", "h", 5, "h", 6, router_register=False)
    fleet.manager._ready.add("s1")
    a = fleet.scaler(cooldown_s=3600.0)
    a._last_scale = time.monotonic()
    fleet.router.replicas["r0"]["dead"] = True
    rep = [d for d in a.evaluate() if d["action"] == "replace"]
    assert rep and rep[0]["dead"] == "r0" and rep[0]["mode"] == "spare_promotion" and rep[0]["replica"] == "s1"
    assert "r0" in fleet.manager.detached and set(fleet.router.replicas) == {"r1", "s1"}


def test_spare_pool_replenished(fleet):
    fleet.manager.attach("r0", "h", 1, "h", 2)
    _load(fleet, "r0", p99_ms=50.0, depth=0)
    a = fleet.scaler(warm_spares=2, down_evals=99)
    assert [d["action"] for d in a.evaluate()] == ["boot_spare", "boot_spare"]
    assert _until(lambda: len(fleet.manager.spares()) == 2)
    assert all(not reg for _, reg in fleet.boots) and a.evaluate() == []


def test_hot_replica_is_a_breach_even_with_idle_siblings(fleet):
    fleet.manager.attach("r0", "h", 1, "h", 2)
    fleet.manager.attach("r1", "h", 3, "h", 4)
    _load(fleet, "r0", p99_ms=1.0, depth=0)
    _load(fleet, "r1", p99_ms=999.0, depth=0)
    assert [d["action"] for d in fleet.scaler().evaluate()] == ["scale_up"]


def test_env_overrides(fleet, monkeypatch):
    monkeypatch.setenv("ODTP_FLEET_SLO_P99_MS", "250")
    monkeypatch.setenv("ODTP_FLEET_WARM_SPARES", "3")
    monkeypatch.setenv("ODTP_FLEET_SCALE_COOLDOWN_S", "7.5")
    a = fleet.scaler(slo_p99_ms=100.0, warm_spares=0, cooldown_s=0.0)
    assert (a.slo_p99_ms, a.warm_spares, a.cooldown_s) == (250.0, 3, 7.5)


def test_decision_log_carries_evidence(fleet):
    fleet.manager.attach("r0", "h", 1, "h", 2)
    a = fleet.scaler()
    _load(fleet, "r0", p99_ms=500.0, depth=11)
    a.evaluate()
    d = list(a.decisions)[-1]
    assert (d["action"], d["p99_ms"], d["queue_depth"], d["tick"]) == ("scale_up", 500.0, 11, 1)
    st = a.status()
    assert st["decisions"] and st["active"] == sorted(fleet.router.replicas)


def test_loop_thread_runs_and_stops(fleet):
    fleet.manager.attach("r0", "h", 1, "h", 2)
    a = fleet.scaler(eval_interval_s=0.01)
    a.start()
    try:
        assert _until(lambda: a.ticks >= 3)
    finally:
        a.stop()
    t = a.ticks
    time.sleep(0.05)
    assert a.ticks == t


def test_decisions_equal_the_reference_tick_for_tick():
    """One scripted load trace through the port's and the JAX autoscaler,
    each over its own fake fleet: the same decisions on the same ticks.
    Boots are waited for between ticks, so both see the same fleet."""
    runs = []
    for cls in (FleetAutoscaler, JFleetAutoscaler):
        f = _fleet(cls)
        f.manager.attach("r0", "h", 1, "h", 2)
        a = f.scaler(warm_spares=1, up_evals=2, down_evals=3, max_replicas=3)
        trace = [500, 500, 500, 20, 5, 5, 5, 5, 900, 900, 5, 5, 5, 5]
        log = []
        for t, p99 in enumerate(trace):
            for rid in list(f.router.replicas):
                _load(f, rid, p99_ms=float(p99), depth=0)
            if t == 6:  # the first active replica dies
                f.router.replicas[sorted(f.router.replicas)[0]]["dead"] = True
            made = a.evaluate()
            log.append([{k: v for k, v in d.items() if k != "exemplars"} for d in made])
            assert _until(lambda: not a._booting and not a._booting_active)
        runs.append(log)
    assert runs[0] == runs[1]
    assert any(d["action"] == "replace" for tick in runs[0] for d in tick)


# ---------------------------------------------------------------------------
# the real manager, and build_fleet with an autoscaler
# ---------------------------------------------------------------------------


def test_manager_spares_promote_demote_and_health(tiny_cfg):
    from opendiloco_torch.fleet import FleetManager
    from opendiloco_torch.fleet.publisher import DeltaPublisher
    from opendiloco_torch.fleet.replica import Replica
    from opendiloco_torch.fleet.router import FleetRouter
    from opendiloco_torch.models.llama import LlamaConfig, flatten_params, init_params

    cfg = LlamaConfig.from_dict(tiny_cfg.to_dict())
    masters = [p.numpy() for p in flatten_params(init_params(torch.Generator().manual_seed(3), cfg))]
    pub = DeltaPublisher(lambda: (0, masters), fragments=2)
    router = FleetRouter(port=0, probe_interval_s=30.0)
    mgr = FleetManager(pub, router, push_interval_s=0.05)
    geom = dict(num_slots=2, max_context=64, prefill_buckets=(8, 16))
    reps = [Replica(f"x{i}", cfg, device="cpu", **geom) for i in range(2)]
    try:
        mgr.attach("x0", "127.0.0.1", reps[0].server.port, "127.0.0.1", reps[0].push_port)
        mgr.attach("x1", "127.0.0.1", reps[1].server.port, "127.0.0.1", reps[1].push_port, router_register=False)
        assert mgr.spares() == ["x1"] and sorted(router.stats()["replicas"]) == ["x0"]
        assert _until(lambda: mgr.spare_ready("x1"), 30)
        # x0's first push reply may land after x1's
        assert _until(lambda: set(mgr.health_matrix()) == {"x0", "x1"}, 30)
        assert {"queue_depth", "occupancy", "p99_ms", "staleness", "ready"} <= set(mgr.health_matrix()["x1"])
        assert mgr.promote("x1") and mgr.spares() == [] and sorted(router.stats()["replicas"]) == ["x0", "x1"]
        assert not mgr.promote("x1") and mgr.demote("x0") and mgr.spares() == ["x0"]
        assert mgr.addr("x0") == ("127.0.0.1", reps[0].server.port)
        out = router.dispatch({"prompt": [1, 2, 3], "max_new_tokens": 2})
        assert len(out["tokens"]) == 2 and out["epoch"] == 0
    finally:
        mgr.stop()
        router.stop()
        for r in reps:
            r.stop()


def test_build_fleet_replaces_a_dead_replica_with_a_warm_spare(tiny_cfg):
    from opendiloco_torch import fleet as tfleet
    from opendiloco_torch.config import FleetConfig
    from opendiloco_torch.models.llama import LlamaConfig, init_params

    cfg = LlamaConfig.from_dict(tiny_cfg.to_dict())
    params = init_params(torch.Generator().manual_seed(5), cfg)
    fcfg = FleetConfig(enabled=True, replicas=2, inprocess=True, max_batch=2, max_context=64, prefill_buckets=[8, 16],
                       push_interval_s=0.05, autoscale=True, warm_spares=1, scale_eval_interval_s=0.05,
                       min_replicas=2, max_replicas=3, scale_down_evals=10_000)
    plane = tfleet.build_fleet(fcfg, cfg, params, device="cpu")
    try:
        assert tfleet.status()["enabled"] and set(plane.router.stats()["replicas"]) == {"r0", "r1"}
        assert _until(lambda: any(plane.manager.spare_ready(s) for s in plane.manager.spares()), 60)
        spare = plane.manager.spares()[0]
        assert plane.router.dispatch({"prompt": [4, 5, 6], "max_new_tokens": 2}).get("tokens")
        plane.replicas["r0"].stop()  # its sockets stop answering
        plane.router._mark_dead(plane.router._backends["r0"])
        assert _until(lambda: "r0" not in plane.router.stats()["replicas"]
                      and spare in plane.router.stats()["replicas"], 30)
        replace = [d for d in plane.autoscaler.decisions if d["action"] == "replace"]
        assert replace[0]["dead"] == "r0" and replace[0]["mode"] == "spare_promotion"
        assert replace[0]["replica"] == spare
        outs = [plane.router.dispatch({"prompt": [7, 8, 9], "max_new_tokens": 2}) for _ in range(4)]
        assert all(len(o.get("tokens", [])) == 2 for o in outs)
        assert np.isfinite(plane.status()["publisher"]["fp16_snapshot_bytes"])
    finally:
        plane.stop()
    assert tfleet.status() == {"enabled": False}
