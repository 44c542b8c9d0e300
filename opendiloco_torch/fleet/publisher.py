"""Delta-push weight publisher: the training side of the serving fleet.

The port's copy of ``opendiloco_tpu/fleet/publisher.py``. One trainer
feeds N serving replicas. Per replica the publisher keeps a *shadow*, the
replica's weights tracked bit for bit on this side (both ends run the
same decode). After each outer epoch a push is either:

- a **keyframe**: every leaf in the state codec (fp16 unless
  ``ODTP_STATE_CODEC`` says otherwise), for a fresh or rejoining replica
  and every ``keyframe_every`` epochs (``ODTP_FLEET_KEYFRAME_EVERY``
  overrides). It replaces the replica's state whole, so weights are bit
  for bit a fresh install at every keyframe boundary.
- a **delta frame**: ONE fragment per epoch on the staggered streaming
  schedule (``planner.fragment_partition`` over the leaf sizes, fragment
  ``epoch % n_frag``), ``master - last pushed`` per leaf in the configured
  sub-8-bit codec, plus a per-replica error-feedback residual, so the
  quantization error re-enters that fragment's next push.

:meth:`DeltaPublisher.frames` returns ``(meta, payload)`` pairs for the
fleet manager to ship (``fleet/wire.py``); :func:`apply_frame` is the one
decode, shared by the replica and the publisher's shadow. Frames are the
JAX package's bytes for the same masters, so either package's replica
takes either package's frames. Armed (``ODTP_OBS``), every frame counts
``fleet_push_bytes`` and ``fleet_push_frames`` by kind and replica and its
codec's ``record_wire`` bytes, under the JAX package's names.
"""
from __future__ import annotations

import os
import threading
from typing import Callable, Optional

import numpy as np

from opendiloco_torch import obs
from opendiloco_torch.diloco.compression import get_codec, record_wire
from opendiloco_torch.diloco.planner import fragment_partition
from opendiloco_torch.diloco.state_io import state_codec

# snapshot_fn: () -> (epoch, [numpy leaves]) in flatten_params order, as
# DiLoCoOptimizer.master_snapshot gives them
SnapshotFn = Callable[[], tuple]


class FleetFrameError(RuntimeError):
    """A push frame does not apply to the receiver's current state."""


def _keyframe_codec_name(delta_codec_name: str) -> str:
    """Keyframes ride the state codec of a peer's state fetch."""
    return state_codec(get_codec(delta_codec_name)).name


def decode_leaf(codec, ent: dict, payload: bytes) -> np.ndarray:
    """One ``leaves`` entry of a frame, decoded to a flat f32 array."""
    seg = payload[int(ent["off"]):int(ent["off"]) + int(ent["len"])]
    shape = tuple(ent["shape"])
    n = int(np.prod(shape)) if shape else 1
    return np.array(codec.decode(seg, (n,), ent["meta"]), np.float32)


def apply_frame(leaves: Optional[list], meta: dict, payload: bytes) -> tuple[list, int]:
    """Apply one weight frame to a flat f32 leaf list: a keyframe returns a
    fresh list (``leaves`` may be None), a delta adds in place. Returns
    ``(leaves, epoch)``."""
    kind = meta.get("kind")
    if kind not in ("keyframe", "delta"):
        raise FleetFrameError(f"not a weight frame: {kind!r}")
    codec = get_codec(meta["codec"])
    if kind == "keyframe":
        return [decode_leaf(codec, ent, payload) for ent in meta["leaves"]], int(meta["epoch"])
    if leaves is None:
        raise FleetFrameError("delta frame before any keyframe")
    for ent in meta["leaves"]:
        dec = decode_leaf(codec, ent, payload)
        np.add(leaves[int(ent["i"])], dec, out=leaves[int(ent["i"])])
    return leaves, int(meta["epoch"])


class _Channel:
    """One replica's push state: shadow, residuals, byte counts."""

    __slots__ = ("shadow", "epoch", "last_keyframe", "residual", "delta_bytes", "keyframe_bytes", "delta_frames",
                 "keyframe_frames")

    def __init__(self) -> None:
        self.shadow: Optional[list] = None
        self.epoch = -1
        self.last_keyframe = -1
        self.residual: dict[int, np.ndarray] = {}
        self.delta_bytes = 0
        self.keyframe_bytes = 0
        self.delta_frames = 0
        self.keyframe_frames = 0


class DeltaPublisher:
    def __init__(self, snapshot_fn: SnapshotFn, *, codec: str = "blockwise4bit", fragments: int = 4,
                 keyframe_every: int = 8, error_feedback: bool = True):
        env = os.environ.get("ODTP_FLEET_KEYFRAME_EVERY")
        self.keyframe_every = max(1, int(env) if env else int(keyframe_every))
        self.snapshot_fn = snapshot_fn
        self.codec = get_codec(codec)
        self.kf_codec = get_codec(_keyframe_codec_name(codec))
        self.fragments = max(1, int(fragments))
        self.error_feedback = bool(error_feedback)
        self._channels: dict[str, _Channel] = {}
        self._lock = threading.Lock()
        self._partition: Optional[list] = None
        self._shapes: Optional[list] = None
        self.fp16_snapshot_bytes = 0  # a full fp16 snapshot's bytes
        self.last_epoch = -1

    # -- membership ----------------------------------------------------------

    def register(self, rid: str) -> None:
        with self._lock:
            self._channels.setdefault(rid, _Channel())

    def drop(self, rid: str) -> None:
        with self._lock:
            self._channels.pop(rid, None)

    def channel_epoch(self, rid: str) -> int:
        """The last epoch pushed to ``rid`` (-1 when fresh)."""
        with self._lock:
            ch = self._channels.get(rid)
            return -1 if ch is None else ch.epoch

    def reset(self, rid: str) -> None:
        """Forget the shadow (the replica lost its state): the next push is
        a keyframe."""
        with self._lock:
            if rid in self._channels:
                self._channels[rid] = _Channel()

    # -- frames ----------------------------------------------------------------

    def _masters(self) -> tuple[int, list]:
        epoch, leaves = self.snapshot_fn()
        flat = [np.asarray(m, np.float32).reshape(-1) for m in leaves]
        if self._shapes is None:
            self._shapes = [tuple(np.asarray(m).shape) for m in leaves]
            sizes = [f.size for f in flat]
            self._partition = fragment_partition(sizes, min(self.fragments, len(sizes)))
            self.fp16_snapshot_bytes = 2 * int(sum(sizes))
        self.last_epoch = int(epoch)
        return int(epoch), flat

    def frames(self, rid: str) -> list[tuple[dict, bytes]]:
        """What ``rid`` needs to catch up with the current masters: [] when
        current, one keyframe, or one delta frame (meta layouts:
        ``diloco/schema.py`` FLEET_KEYFRAME_META_FIELDS and
        FLEET_DELTA_META_FIELDS)."""
        with self._lock:
            ch = self._channels.setdefault(rid, _Channel())
            epoch, masters = self._masters()
            if ch.shadow is not None and ch.epoch >= epoch:
                return []
            if ch.shadow is None or epoch - ch.last_keyframe >= self.keyframe_every:
                return [self._keyframe(ch, rid, epoch, masters)]
            return self._deltas(ch, rid, epoch, masters)

    def _keyframe(self, ch: _Channel, rid: str, epoch: int, masters: list) -> tuple[dict, bytes]:
        ents, parts, off = [], [], 0
        for i, (flat, shape) in enumerate(zip(masters, self._shapes)):
            payload, meta = self.kf_codec.encode(flat)
            ents.append({"i": i, "shape": list(shape), "off": off, "len": len(payload), "meta": meta})
            parts.append(payload)
            off += len(payload)
        frame_meta = {"kind": "keyframe", "epoch": epoch, "tepoch": epoch, "codec": self.kf_codec.name,
                      "leaves": ents}
        payload = b"".join(parts)
        # the shadow is the decode of what was sent: publisher and replica
        # share apply_frame, so they stay bit for bit equal
        ch.shadow, ch.epoch = apply_frame(None, frame_meta, payload)
        ch.last_keyframe = epoch
        ch.residual.clear()
        ch.keyframe_bytes += off
        ch.keyframe_frames += 1
        obs.count("fleet_push_bytes", off, kind="keyframe", replica=rid)
        obs.count("fleet_push_frames", kind="keyframe", replica=rid)
        record_wire(self.kf_codec.name, self.fp16_snapshot_bytes * 2, off)
        return frame_meta, payload

    def _deltas(self, ch: _Channel, rid: str, epoch: int, masters: list) -> list[tuple[dict, bytes]]:
        """One self-contained delta frame: the fragment whose turn this
        epoch is, carrying all its leaves moved since their last push."""
        base = ch.epoch
        nfrag = len(self._partition)
        frag = epoch % nfrag
        ents, parts, off = [], [], 0
        for i in self._partition[frag]:
            d = masters[i] - ch.shadow[i]
            if self.error_feedback and i in ch.residual:
                d = d + ch.residual[i]
            payload, meta = self.codec.encode(d)
            dec = np.array(self.codec.decode(payload, d.shape, meta), np.float32)
            if self.error_feedback:
                ch.residual[i] = d - dec
            np.add(ch.shadow[i], dec, out=ch.shadow[i])
            ents.append({"i": i, "shape": list(self._shapes[i]), "off": off, "len": len(payload), "meta": meta})
            parts.append(payload)
            off += len(payload)
            record_wire(self.codec.name, d.nbytes, len(payload))
        ch.delta_bytes += off
        ch.delta_frames += 1
        ch.epoch = epoch
        obs.count("fleet_push_bytes", off, kind="delta", replica=rid)
        obs.count("fleet_push_frames", kind="delta", replica=rid)
        return [({"kind": "delta", "epoch": epoch, "tepoch": epoch, "base_epoch": base, "frag": frag,
                  "nfrag": nfrag, "codec": self.codec.name, "leaves": ents}, b"".join(parts))]

    # -- introspection -------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            return {
                "epoch": self.last_epoch,
                "codec": self.codec.name,
                "keyframe_codec": self.kf_codec.name,
                "keyframe_every": self.keyframe_every,
                "error_feedback": self.error_feedback,
                "fp16_snapshot_bytes": self.fp16_snapshot_bytes,
                "replicas": {
                    rid: {
                        "epoch": ch.epoch,
                        "last_keyframe": ch.last_keyframe,
                        "delta_bytes": ch.delta_bytes,
                        "keyframe_bytes": ch.keyframe_bytes,
                        "delta_frames": ch.delta_frames,
                        "keyframe_frames": ch.keyframe_frames,
                    }
                    for rid, ch in self._channels.items()
                },
            }
