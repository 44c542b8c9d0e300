"""Serving fleet: replicas fed by delta pushes, behind one router.

The port's copy of ``opendiloco_tpu/fleet``. The trainer keeps training;
a :class:`~opendiloco_torch.fleet.publisher.DeltaPublisher` encodes each
outer epoch's master movement as codec-compressed fragment deltas (with
error feedback and periodic keyframes); replicas
(:mod:`~opendiloco_torch.fleet.replica`, in process or as processes)
apply them into their own engines; a
:class:`~opendiloco_torch.fleet.router.FleetRouter` spreads client
traffic, least-loaded with prefix affinity. A replica that joins, leaves
or is killed is absorbed by the router's redispatch and the publisher's
keyframes. Frames, the push wire and the router's protocols are the JAX
package's, so port and JAX pieces mix in one fleet.

``build_fleet(fleet_cfg, model_cfg, params, diloco_opt)`` assembles it
(``train()`` calls it when ``config.fleet.enabled``); :func:`status` is
what the control port's ``fleet`` RPC answers. Armed (``ODTP_OBS``), the
manager counts spare promotions and each replica's staleness, publishes
its staleness, queue depth and p99 gauges, and merges each replica's
overseer roll-up into this process's matrix as ``replica:<rid>``, whose
rows then overlay :meth:`FleetManager.health_matrix`, as the JAX package
does.
"""
from __future__ import annotations

import dataclasses
import json
import os
import socket
import subprocess
import sys
import tempfile
import threading
from typing import Any, Optional

from opendiloco_torch import obs
from opendiloco_torch.fleet.autoscaler import FleetAutoscaler
from opendiloco_torch.fleet.publisher import DeltaPublisher, apply_frame  # noqa: F401
from opendiloco_torch.fleet.router import FleetRouter
from opendiloco_torch.fleet.wire import FleetWireError, recv_frame, send_frame
from opendiloco_torch.utils.logger import get_text_logger

__all__ = [
    "DeltaPublisher",
    "FleetAutoscaler",
    "FleetManager",
    "FleetPlane",
    "FleetRouter",
    "apply_frame",
    "build_fleet",
    "spawn_replica",
    "status",
]

log = get_text_logger(__name__)

# the kernels a replica's decode launches: B6 on B7's split kernel (and the
# first design above head dim 128), B7 on prefix hits
SERVING_KERNELS = ("spec_tail_attention", "paged_decode_attention")


class FleetManager:
    """One pusher thread per replica: ships the publisher's frames over the
    push channel, pings when there is nothing to ship (so the replica's
    staleness keeps moving), keeps each replica's last health reply, and
    re-keyframes a replica whose state no longer matches the publisher's
    shadow (a restart, a stale delta base)."""

    def __init__(self, publisher: DeltaPublisher, router: Optional[FleetRouter] = None, *,
                 push_interval_s: float = 0.25):
        env = os.environ.get("ODTP_FLEET_PUSH_INTERVAL_S")
        self.push_interval_s = float(env) if env else float(push_interval_s)
        self.publisher = publisher
        self.router = router
        self._stops: dict[str, threading.Event] = {}
        self._threads: dict[str, threading.Thread] = {}
        self._last_reply: dict[str, dict] = {}
        self._addrs: dict[str, tuple[str, int]] = {}
        self._spares: set[str] = set()
        self._lock = threading.Lock()

    def attach(self, rid: str, serve_host: str, serve_port: int, push_host: str, push_port: int, *,
               router_register: bool = True) -> None:
        """Put ``rid`` on the push channel; ``router_register=False`` makes
        it a warm spare (it follows the pushes but takes no traffic until
        :meth:`promote`)."""
        self.publisher.register(rid)
        with self._lock:
            self._addrs[rid] = (serve_host, int(serve_port))
            if not router_register:
                self._spares.add(rid)
        if router_register and self.router is not None:
            self.router.add_replica(rid, serve_host, serve_port)
        stop = threading.Event()
        t = threading.Thread(target=self._push_loop, args=(rid, push_host, push_port, stop),
                             name=f"odt-fleet-push-{rid}", daemon=True)
        with self._lock:
            self._stops[rid] = stop
            self._threads[rid] = t
        t.start()

    def detach(self, rid: str) -> None:
        with self._lock:
            stop = self._stops.pop(rid, None)
            t = self._threads.pop(rid, None)
            self._addrs.pop(rid, None)
            self._spares.discard(rid)
            self._last_reply.pop(rid, None)
        if stop is not None:
            stop.set()
        if t is not None:
            t.join(timeout=2.0)
        self.publisher.drop(rid)
        if self.router is not None:
            self.router.remove_replica(rid)

    # -- warm spares ---------------------------------------------------------

    def spares(self) -> list:
        with self._lock:
            return sorted(self._spares)

    def addr(self, rid: str) -> Optional[tuple]:
        """(serve_host, serve_port) of an attached replica or spare."""
        with self._lock:
            return self._addrs.get(rid)

    def spare_ready(self, rid: str) -> bool:
        """A spare may be promoted once a push reply showed applied weights
        and its health says ready."""
        with self._lock:
            if rid not in self._spares:
                return False
            rmeta = self._last_reply.get(rid)
        if not rmeta:
            return False
        h = rmeta.get("health") or {}
        return bool(rmeta.get("ready", h.get("ready"))) and int(rmeta.get("weights_epoch", -1)) >= 0

    def promote(self, rid: str) -> bool:
        """Hand a warm spare's address to the router."""
        if self.router is None:
            return False
        with self._lock:
            addr = self._addrs.get(rid)
            if rid not in self._spares or addr is None:
                return False
            self._spares.discard(rid)
        self.router.add_replica(rid, addr[0], addr[1])
        obs.count("fleet_spare_promotions", replica=rid)
        return True

    def demote(self, rid: str) -> bool:
        """Take ``rid`` out of the router but keep it following the pushes,
        so it can be promoted again at once."""
        with self._lock:
            if rid in self._spares or rid not in self._addrs:
                return False
            self._spares.add(rid)
        if self.router is not None:
            self.router.remove_replica(rid)
        return True

    def _note_reply(self, rid: str, rmeta: dict) -> None:
        with self._lock:
            self._last_reply[rid] = rmeta
        st = rmeta.get("staleness")
        if st is not None:
            obs.count("fleet_staleness_rounds", 1, replica=rid, rounds=int(st))
            obs.gauge("fleet_replica_staleness", int(st), replica=rid)
        h = rmeta.get("health")
        if h:
            if self.router is not None:
                # the prefix directory's feed (no key: nothing resident)
                self.router.update_prefixes(rid, h.get("prefixes") or [])
            if h.get("queue_depth") is not None:
                obs.gauge("fleet_replica_queue_depth", int(h["queue_depth"]), replica=rid)
            if h.get("p99_ms") is not None:
                obs.gauge("fleet_replica_p99_ms", float(h["p99_ms"]), replica=rid)
        vec = rmeta.get("rollup")
        if vec:
            ov = obs.overseer.plane()
            if ov is not None:
                ov.merge(f"replica:{rid}", vec)

    def health_matrix(self) -> dict:
        """rid -> the latest load and health vector of its push replies,
        overlaid, when armed, by the overseer matrix's replica rows: the
        autoscaler's view of the fleet."""
        out: dict[str, dict] = {}
        with self._lock:
            for rid, rmeta in self._last_reply.items():
                h = rmeta.get("health")
                if h:
                    out[rid] = dict(h)
        ov = obs.overseer.plane()
        if ov is not None:
            for peer, vec in ov.matrix().items():
                if not peer.startswith("replica:"):
                    continue
                row = out.setdefault(peer.split(":", 1)[1], {})
                for k in ("queue_depth", "occupancy", "p99_ms", "staleness", "stale"):
                    if vec.get(k) is not None:
                        row[k] = vec[k]
        return out

    def _push_loop(self, rid: str, host: str, port: int, stop: threading.Event) -> None:
        sock: Optional[socket.socket] = None
        while not stop.is_set():
            try:
                if sock is None:
                    sock = socket.create_connection((host, port), timeout=2.0)
                    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                    send_frame(sock, "hello", {"kind": "hello"})
                    _, rmeta, _ = recv_frame(sock, timeout=10.0)
                    # a restarted replica answers with another epoch than
                    # the shadow's: forget the shadow, keyframe again
                    if int(rmeta.get("epoch", -1)) != self.publisher.channel_epoch(rid):
                        self.publisher.reset(rid)
                frames = self.publisher.frames(rid)
                for meta, payload in frames:
                    send_frame(sock, meta["kind"], meta, payload)
                    kind, rmeta, _ = recv_frame(sock, timeout=60.0)
                    if kind != "ok":
                        self.publisher.reset(rid)
                        break
                    self._note_reply(rid, rmeta)
                if not frames:
                    send_frame(sock, "ping", {"kind": "ping", "tepoch": self.publisher.last_epoch})
                    kind, rmeta, _ = recv_frame(sock, timeout=10.0)
                    if kind == "ok":
                        self._note_reply(rid, rmeta)
            except (OSError, FleetWireError, ValueError):
                if sock is not None:
                    try:
                        sock.close()
                    except OSError:
                        pass
                    sock = None
            stop.wait(self.push_interval_s)
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    def stop(self) -> None:
        with self._lock:
            rids = list(self._stops)
        for rid in rids:
            self.detach(rid)

    def status(self) -> dict:
        with self._lock:
            return {"replicas": dict(self._last_reply), "spares": sorted(self._spares)}


def spawn_replica(replica_id: str, model_cfg, *, serve: Optional[dict] = None, max_stale_rounds: int = 2,
                  host: str = "127.0.0.1", serve_port: int = 0, push_port: int = 0, seed: int = 0,
                  env: Optional[dict] = None, timeout: float = 120.0, device=None) -> tuple:
    """Start ``python -m opendiloco_torch.fleet.replica`` on ``device`` (the
    card when None) and wait for its ready line. Returns ``(Popen, info)``
    with the bound ports. Explicit ports let a respawned replica rejoin at
    its old address."""
    spec = {
        "replica_id": replica_id,
        "model": model_cfg.to_dict(),
        "serve": serve or {},
        "max_stale_rounds": int(max_stale_rounds),
        "host": host,
        "serve_port": int(serve_port),
        "push_port": int(push_port),
        "seed": int(seed),
    }
    fd, path = tempfile.mkstemp(prefix=f"odt-replica-{replica_id}-", suffix=".json")
    with os.fdopen(fd, "w") as f:
        json.dump(spec, f)
    child_env = dict(os.environ)
    # the package's checkout first on the child's path, wherever it runs
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    child_env["PYTHONPATH"] = os.pathsep.join(p for p in (root, child_env.get("PYTHONPATH")) if p)
    if env:
        child_env.update(env)
    cmd = [sys.executable, "-m", "opendiloco_torch.fleet.replica", "--spec", path]
    if device is not None:
        cmd += ["--device", str(device)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, env=child_env, text=True)

    info: dict = {}

    def _read() -> None:
        line = proc.stdout.readline()
        if line:
            try:
                info.update(json.loads(line))
            except ValueError:
                pass

    reader = threading.Thread(target=_read, daemon=True)
    reader.start()
    reader.join(timeout=timeout)
    try:
        os.unlink(path)
    except OSError:
        pass
    if not info:
        proc.kill()
        proc.wait(timeout=10.0)
        raise RuntimeError(f"replica {replica_id} did not report ready within {timeout}s")
    return proc, info


@dataclasses.dataclass
class FleetPlane:
    """The live fleet, with one-call teardown (``train()``'s finally)."""

    publisher: DeltaPublisher
    router: FleetRouter
    manager: FleetManager
    replicas: dict  # rid -> Replica (in process) or subprocess.Popen
    autoscaler: Optional[FleetAutoscaler] = None

    @property
    def port(self) -> int:
        return self.router.port

    def status(self) -> dict:
        out = {"router": self.router.stats(), "publisher": self.publisher.stats(), "manager": self.manager.status()}
        if self.autoscaler is not None:
            out["autoscaler"] = self.autoscaler.status()
        return out

    def stop(self) -> None:
        if self.autoscaler is not None:
            self.autoscaler.stop()
        self.manager.stop()
        self.router.stop()
        for rep in list(self.replicas.values()):
            _stop_replica(rep)
        if _plane is self:
            register_plane(None)


def _stop_replica(rep) -> None:
    if hasattr(rep, "stop"):
        rep.stop()
    else:
        rep.kill()
        rep.wait(timeout=5.0)


# the control port's "fleet" RPC source: this process's live plane
_plane: Optional[FleetPlane] = None


def register_plane(plane: Optional[FleetPlane]) -> None:
    global _plane
    _plane = plane


def status() -> dict:
    if _plane is None:
        return {"enabled": False}
    return {"enabled": True, **_plane.status()}


def build_fleet(fleet_cfg, model_cfg, params, diloco_opt=None, *, compute_dtype=None, device=None) -> FleetPlane:
    """Publisher, router and replicas from a ``config.FleetConfig``.
    ``diloco_opt`` supplies the live masters (``master_snapshot``); None
    publishes host copies of ``params`` as a static epoch-0 snapshot.
    Replicas serve on ``device`` (the card when None; a trainer passes its
    own); on the card the serving kernels are built here first, so that
    replica processes start on built libraries."""
    import torch

    from opendiloco_torch.device import resolve_device
    from opendiloco_torch.models.llama import flatten_params

    dev = resolve_device(device)
    if diloco_opt is not None:
        snapshot_fn = diloco_opt.master_snapshot
    else:
        # host copies: a trainer steps its params in place
        static = [torch.as_tensor(x).detach().to("cpu", torch.float32, copy=True).numpy()
                  for x in flatten_params(params)]
        snapshot_fn = lambda: (0, static)  # noqa: E731
    if dev.type == "cuda":
        from opendiloco_torch.ops import build

        build.build(SERVING_KERNELS)
    codec = os.environ.get("ODTP_FLEET_CODEC") or fleet_cfg.codec
    publisher = DeltaPublisher(snapshot_fn, codec=codec, fragments=fleet_cfg.fragments,
                               keyframe_every=fleet_cfg.keyframe_every, error_feedback=fleet_cfg.error_feedback)
    env_dir = os.environ.get("ODTP_PREFIX_DIRECTORY")
    prefix_directory = bool(int(env_dir)) if env_dir else fleet_cfg.prefix_directory
    router = FleetRouter(host=fleet_cfg.host, port=fleet_cfg.port, prefix_directory=prefix_directory)
    manager = FleetManager(publisher, router, push_interval_s=fleet_cfg.push_interval_s)
    serve_geom = {
        "num_slots": fleet_cfg.max_batch,
        "max_context": fleet_cfg.max_context,
        "prefill_buckets": list(fleet_cfg.prefill_buckets),
        "max_queue": fleet_cfg.max_queue,
        "prefix_cache": fleet_cfg.prefix_cache,
        # the directory advertises host-tier entries: it arms each tier
        "kv_tier": prefix_directory,
    }
    replicas: dict[str, Any] = {}

    def _boot(rid: str, register: bool = True) -> None:
        """Make one replica and attach it (``register=False``: a warm
        spare); the initial bring-up and the autoscaler's boots."""
        if fleet_cfg.inprocess:
            from opendiloco_torch.fleet.replica import Replica

            rep = Replica(rid, model_cfg, max_stale_rounds=fleet_cfg.max_stale_rounds, host=fleet_cfg.host,
                          compute_dtype=compute_dtype, device=dev, **serve_geom)
            replicas[rid] = rep
            serve_port, push_port = rep.server.port, rep.push_port
        else:
            proc, info = spawn_replica(rid, model_cfg, serve=serve_geom, max_stale_rounds=fleet_cfg.max_stale_rounds,
                                       host=fleet_cfg.host, device=dev)
            replicas[rid] = proc
            serve_port, push_port = info["serve_port"], info["push_port"]
        manager.attach(rid, fleet_cfg.host, serve_port, fleet_cfg.host, push_port, router_register=register)

    def _retire(rid: str) -> None:
        manager.detach(rid)
        rep = replicas.pop(rid, None)
        if rep is not None:
            _stop_replica(rep)

    try:
        if fleet_cfg.inprocess:
            for i in range(fleet_cfg.replicas):
                _boot(f"r{i}", True)
        else:
            # processes start side by side: each spends seconds on its
            # interpreter, torch and device before its ready line
            errors: list = []

            def boot(rid: str) -> None:
                try:
                    _boot(rid, True)
                except BaseException as e:
                    errors.append(e)

            threads = [threading.Thread(target=boot, args=(f"r{i}",)) for i in range(fleet_cfg.replicas)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            if errors:
                raise errors[0]
    except BaseException:
        manager.stop()
        router.stop()
        for rep in replicas.values():
            _stop_replica(rep)
        raise

    autoscaler = None
    if fleet_cfg.autoscale or fleet_cfg.warm_spares > 0:
        autoscaler = FleetAutoscaler(
            manager,
            router,
            slo_p99_ms=fleet_cfg.slo_p99_ms,
            slo_queue_depth=fleet_cfg.slo_queue_depth,
            min_replicas=fleet_cfg.min_replicas,
            max_replicas=fleet_cfg.max_replicas,
            warm_spares=fleet_cfg.warm_spares,
            cooldown_s=fleet_cfg.scale_cooldown_s,
            eval_interval_s=fleet_cfg.scale_eval_interval_s,
            up_evals=fleet_cfg.scale_up_evals,
            down_evals=fleet_cfg.scale_down_evals,
            boot_fn=_boot,
            retire_fn=_retire,
        ).start()
    plane = FleetPlane(publisher=publisher, router=router, manager=manager, replicas=replicas, autoscaler=autoscaler)
    register_plane(plane)
    return plane
