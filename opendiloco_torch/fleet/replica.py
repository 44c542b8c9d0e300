"""Replica runner: one serving engine fed by the fleet's push channel.

The port's copy of ``opendiloco_tpu/fleet/replica.py``. A replica is
``ServeEngine + ContinuousBatcher + ServeServer`` and a push listener.
The listener applies keyframe and delta frames
(:func:`~opendiloco_torch.fleet.publisher.apply_frame`) into a host f32
mailbox under a lock; the engine adopts each fully applied epoch through
its ``snapshot_fn``/``maybe_swap`` between decode steps, so weight
rebinds stay on the batcher's thread and a half-applied push is never
served.

Staleness has two levels: the engine's ``epoch_fn`` follows the mailbox
(the engine adopts every new push), and :meth:`Replica.staleness`
follows the trainer's epoch (pings move it even when pushes stall)
against ``max_stale_rounds``, the health bound the router sees. Weights
are random (from ``seed``) until the first keyframe lands, which is what
:meth:`Replica.ready` waits for.

In process (tests, ``fleet.inprocess``), or as a process::

    python -m opendiloco_torch.fleet.replica --spec spec.json [--device cpu]

which prints one JSON line (``replica_id``, the bound ``serve_port`` and
``push_port``, ``pid``) and serves until killed. It runs on the card
unless ``--device`` names another device. The spec is the JAX package's
(``fleet.spawn_replica`` writes it), so a port replica takes a JAX
publisher's frames and serves behind a JAX router, and the other way
round. Armed (``ODTP_OBS``), the replica names itself to the tracer and
the request-trace ring, counts ``fleet_frames_applied`` by kind, adds its
overseer roll-up to every push reply (``rollup``) and answers the
``reqtrace`` frame with its ring's snapshot, as a JAX replica does.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import threading
from typing import Optional

from opendiloco_torch import obs
from opendiloco_torch.fleet.publisher import FleetFrameError, apply_frame
from opendiloco_torch.fleet.wire import FleetWireError, recv_frame, send_frame
from opendiloco_torch.utils.logger import get_text_logger

log = get_text_logger(__name__)


class Replica:
    def __init__(self, replica_id: str, model_cfg, *, num_slots: int = 4, max_context: int = 128,
                 prefill_buckets=(16, 64), max_queue: int = 1024, max_stale_rounds: int = 2,
                 host: str = "127.0.0.1", serve_port: int = 0, push_port: int = 0, prefix_cache: bool = True,
                 kv_tier: bool = False, kv_tier_codec: str = "none", kv_host_slots: int = 32, compute_dtype=None,
                 seed: int = 0, start_push_server: bool = True, device=None):
        import torch

        from opendiloco_torch.device import resolve_device
        from opendiloco_torch.models.llama import flatten_params, init_params
        from opendiloco_torch.serve.engine import ServeEngine
        from opendiloco_torch.serve.kvcache import HostKVTier
        from opendiloco_torch.serve.scheduler import ContinuousBatcher
        from opendiloco_torch.serve.server import ServeServer, bind_with_fallback

        self.replica_id = str(replica_id)
        self.max_stale_rounds = int(max_stale_rounds)
        self.trainer_epoch = 0
        self._lock = threading.Lock()
        # the mailbox: the last fully applied push (flat f32 leaves); the
        # engine pulls it between decode steps
        self._leaves: Optional[list] = None
        self._epoch = -1
        dev = resolve_device(device)
        params = init_params(torch.Generator(device=dev).manual_seed(int(seed)), model_cfg)
        self._shapes = [tuple(x.shape) for x in flatten_params(params)]
        self.engine = ServeEngine(
            model_cfg,
            params,
            num_slots=num_slots,
            max_context=max_context,
            prefill_buckets=prefill_buckets,
            compute_dtype=compute_dtype or torch.float32,
            epoch=-1,
            device=dev,
            snapshot_fn=self._pull,
            epoch_fn=lambda: self._epoch,
            max_stale_rounds=0,  # adopt every fully applied push
        )
        del params
        self.batcher = ContinuousBatcher(
            self.engine,
            max_queue=max_queue,
            prefix_cache=prefix_cache,
            kv_tier=HostKVTier(host_slots=int(kv_host_slots), codec=str(kv_tier_codec)) if kv_tier else None,
        ).start()
        # an explicit port is a respawn at a known address: retry the bind
        # while the predecessor's listener tears down
        self.server = ServeServer(self.batcher, host=host, port=serve_port, identity=self._identity,
                                  bind_retry_s=3.0 if serve_port else 0.0)
        tr = obs.tracer()
        if tr is not None:
            tr.set_identity(worker=self.replica_id, role="fleet-replica")
        rt = obs.reqtrace.ring()
        if rt is not None:
            rt.set_identity(self.replica_id)
        self._stop = threading.Event()
        self._push_sock: Optional[socket.socket] = None
        self.push_port = 0
        if start_push_server:
            self._push_sock = bind_with_fallback(host, push_port, "fleet-push", retry_s=3.0 if push_port else 0.0)
            self._push_sock.listen(8)
            self.push_port = self._push_sock.getsockname()[1]
            threading.Thread(target=self._push_accept, name=f"odt-fleet-push-{self.replica_id}",
                             daemon=True).start()

    # -- weight state --------------------------------------------------------

    def _pull(self) -> tuple[int, list, str]:
        """The engine's snapshot_fn: the mailbox as raw f32 install_wire
        blobs, copied under the lock so a push never changes bytes
        mid-install."""
        with self._lock:
            if self._leaves is None:
                return self._epoch, [], "none"
            return self._epoch, [(lf.tobytes(), {}, shape) for lf, shape in zip(self._leaves, self._shapes)], "none"

    def apply(self, meta: dict, payload: bytes) -> int:
        """Apply one weight or ping frame; returns the mailbox epoch."""
        kind = meta.get("kind")
        with self._lock:
            if kind == "ping":
                self.trainer_epoch = max(self.trainer_epoch, int(meta.get("tepoch", 0)))
                return self._epoch
            if kind == "delta" and int(meta["base_epoch"]) != self._epoch:
                raise FleetFrameError(f"delta base epoch {meta['base_epoch']} != replica epoch {self._epoch} "
                                      "(need a keyframe)")
            leaves, epoch = apply_frame(self._leaves, meta, payload)
            self._leaves = leaves
            # every frame is whole (a keyframe, or one fragment's delta), so
            # the mailbox epoch moves per frame
            self._epoch = epoch
            self.trainer_epoch = max(self.trainer_epoch, int(meta.get("tepoch", epoch)))
            obs.count("fleet_frames_applied", kind=kind)
            return self._epoch

    # -- health --------------------------------------------------------------

    def ready(self) -> bool:
        return self.engine.weights_epoch >= 0

    def staleness(self) -> int:
        """Outer rounds the SERVED weights lag the trainer."""
        return max(0, self.trainer_epoch - self.engine.weights_epoch)

    def stale(self) -> bool:
        return self.staleness() > self.max_stale_rounds

    def _identity(self) -> dict:
        return {
            "worker": self.replica_id,
            "replica": self.replica_id,
            "trainer_epoch": self.trainer_epoch,
            "staleness": self.staleness(),
            "max_stale_rounds": self.max_stale_rounds,
            "ready": self.ready(),
            "stale": self.stale(),
        }

    def status(self) -> dict:
        return {
            **self._identity(),
            "weights_epoch": self.engine.weights_epoch,
            "mailbox_epoch": self._epoch,
            "serve_port": self.server.port,
            "push_port": self.push_port,
            "free_slots": self.batcher.slots.num_free,
            "completed": self.batcher.completed,
        }

    def health(self) -> dict:
        """The load vector the autoscaler steers on, on every push reply;
        with a host tier, the prefixes it holds at the current weights
        (the router's prefix directory)."""
        out = {**self.batcher.health(), "staleness": self.staleness(), "stale": self.stale(), "ready": self.ready()}
        prefixes = self.batcher.resident_prefixes()
        if prefixes:
            out["prefixes"] = prefixes
        return out

    def rollup(self) -> Optional[dict]:
        """The overseer's health vector for this replica (None unarmed),
        which the fleet manager merges into the trainer's matrix."""
        ov = obs.overseer.plane()
        if ov is None:
            return None
        h = self.batcher.health()
        return ov.rollup(
            role="fleet-replica",
            replica=self.replica_id,
            staleness=self.staleness(),
            weights_epoch=self.engine.weights_epoch,
            stale=self.stale(),
            queue_depth=h["queue_depth"],
            occupancy=h["occupancy"],
            p99_ms=h["p99_ms"],
            # the host tier's load (absent without one): odtp_top's tier%
            **({"tier_occupancy": h["tier_occupancy"]} if "tier_occupancy" in h else {}),
        )

    # -- push channel --------------------------------------------------------

    def _push_accept(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._push_sock.accept()
            except OSError:
                return
            threading.Thread(target=self._push_serve, args=(conn,), daemon=True).start()

    def _push_serve(self, conn: socket.socket) -> None:
        try:
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            while not self._stop.is_set():
                try:
                    kind, meta, payload = recv_frame(conn)
                except (FleetWireError, OSError, ValueError):
                    return
                try:
                    if kind == "hello":
                        reply = {"replica": self.replica_id, "epoch": self._epoch,
                                 "weights_epoch": self.engine.weights_epoch}
                    elif kind == "reqtrace":
                        # this replica's request-trace ring (odtp_top
                        # --requests, obs_report's merge, the router's pull);
                        # None unarmed
                        rt = obs.reqtrace.ring()
                        reply = {"replica": self.replica_id,
                                 "reqtrace": rt.snapshot(recent=int(meta.get("recent", 32))) if rt is not None else None}
                    else:
                        epoch = self.apply(meta, payload)
                        reply = {
                            "replica": self.replica_id,
                            "epoch": epoch,
                            "weights_epoch": self.engine.weights_epoch,
                            "staleness": self.staleness(),
                            "stale": self.stale(),
                            "ready": self.ready(),
                            "free_slots": self.batcher.slots.num_free,
                            "health": self.health(),
                        }
                        vec = self.rollup()
                        if vec is not None:
                            reply["rollup"] = vec
                    send_frame(conn, "ok", reply)
                except FleetFrameError as e:
                    send_frame(conn, "error", {"error": str(e)})
        except OSError:
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def stop(self) -> None:
        self._stop.set()
        if self._push_sock is not None:
            try:
                self._push_sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._push_sock.close()
            except OSError:
                pass
        self.server.stop()
        self.batcher.stop()


# -- the process's entry ------------------------------------------------------


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description="one fleet replica: engine, batcher, server and push listener")
    ap.add_argument("--spec", required=True, help="JSON replica spec file")
    ap.add_argument("--device", default=None, help="the device to serve on (default: the card; 'cpu')")
    args = ap.parse_args(argv)
    with open(args.spec) as f:
        spec = json.load(f)

    from opendiloco_torch.device import pin_cpu_threads, resolve_device
    from opendiloco_torch.models.llama import LlamaConfig

    device = resolve_device(args.device)
    pin_cpu_threads(device)
    model_cfg = LlamaConfig.from_dict(spec["model"])
    serve = spec.get("serve", {})
    replica = Replica(
        spec["replica_id"],
        model_cfg,
        num_slots=int(serve.get("num_slots", 4)),
        max_context=int(serve.get("max_context", 128)),
        prefill_buckets=tuple(serve.get("prefill_buckets", (16, 64))),
        max_queue=int(serve.get("max_queue", 1024)),
        prefix_cache=bool(serve.get("prefix_cache", True)),
        kv_tier=bool(serve.get("kv_tier", False)),
        kv_tier_codec=str(serve.get("kv_tier_codec", "none")),
        kv_host_slots=int(serve.get("kv_host_slots", 32)),
        max_stale_rounds=int(spec.get("max_stale_rounds", 2)),
        host=spec.get("host", "127.0.0.1"),
        serve_port=int(spec.get("serve_port", 0)),
        push_port=int(spec.get("push_port", 0)),
        seed=int(spec.get("seed", 0)),
        device=device,
    )
    print(json.dumps({"replica_id": replica.replica_id, "serve_port": replica.server.port,
                      "push_port": replica.push_port, "pid": os.getpid()}), flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    replica.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
