"""Deterministic, seedable chaos fault-injection plane for the WAN stack.

One env spec scripts every fault class the outer data plane can hit::

    ODTP_CHAOS="seed=7;drop_conn=0.05;delay_ms=20..200;kill_worker=r3:w5;blackout_rdv=r2"

Grammar — ``;``-separated ``key=value`` items:

- ``seed=N``            RNG seed; same spec + seed => same fault sequence.
- ``drop_conn=P``       probability of refusing/resetting a connection-level
                        op (rendezvous RPC, peer RPC, bulk send, inbound
                        peer connection, loopback contribution).
- ``truncate=P``        probability of cutting a bulk transfer mid-payload
                        (half the bytes go out, then the socket dies).
- ``delay_ms=A..B``     read/write latency injected before WAN ops, drawn
                        uniformly from [A, B] ms (``delay_ms=50`` pins it).
- ``delay_p=P``         probability an op draws a delay at all (default 1
                        when ``delay_ms`` is set).
- ``kill_worker=rR:wW`` schedule entry: worker W should be SIGKILLed at
                        outer round R. The plane only *parses and exposes*
                        the schedule (``kill_schedule()``); an orchestrator
                        (scripts/chaos_soak.py, tests) does the killing.
                        Comma-separate for multiple entries.
- ``blackout_rdv=rR``   daemon-side: when the daemon observes its R-th
                        distinct matchmaking round (1-based), it goes dark —
                        drops every frame without replying — for
                        ``blackout_s`` seconds. Comma-separate for several.
- ``blackout_s=S``      blackout duration (default 3.0 s).
- ``straggle_ms=A..B``  extra latency for this process's outer contributions
                        (straggler throttling); scope with
                        ``straggle_worker=W`` + ``set_identity(W)``.
- ``straggle_inner_ms=A..B``  extra latency injected into every INNER
                        training step (slow-host emulation). Unlike
                        ``straggle_ms`` — whose delay the whole barrier-
                        synchronized round absorbs symmetrically — this
                        collapses the worker's own tokens/s, the
                        asymmetric signature the straggler watchdog keys
                        on. Scoped by ``straggle_worker`` too.
- ``straggle_inner_x=X``  sustained inner-step speed multiplier: worker
                        ranks in scope run their inner steps X times
                        slower (the bench/train hook stretches each
                        measured step by (X-1) of its own duration).
                        Scope with ``workers=w3,w7``, or give per-rank
                        factors directly: ``straggle_inner_x=w3:2.0,w7:4.0``.
                        Unlike the one-shot ``straggle_inner_ms`` delays
                        this expresses a deterministic rate skew (2x/4x
                        heterogeneous-galaxy emulation); lookups are pure
                        (NO RNG draw), so concurrent worker threads can
                        query their own factor without perturbing the
                        fault stream.
- ``workers=w3,w7``     rank scope for ``straggle_inner_x`` when given as
                        a single scalar factor.
- ``egress_bps=N``      cap this process's bulk/wire payload egress at N
                        bytes/second (token bucket, same machinery as
                        ``ODTP_BULK_BANDWIDTH_BPS``; when both are set the
                        LOWER cap binds). This is how a bench emulates a
                        bandwidth-skewed galaxy: give one worker's process
                        a chaos spec with a lower cap than its peers.
- ``wan_bps=N``         cap egress to WAN-classified destinations at N
                        bytes/second (separate token bucket, additive with
                        ``egress_bps``: the NIC cap and the site-uplink cap
                        both apply). Destinations are classified by
                        ``wan_peers``.
- ``wan_peers=G|G``     ``|``-separated fnmatch globs over destination peer
                        ids; a match means frames to that peer cross the
                        emulated WAN. Required for ``wan_bps`` to bite.

Design constraints:

- **Zero-cost when disabled.** Hook sites call :func:`plane` which is one
  ``os.environ`` dict hit plus a cached-string compare; when ``ODTP_CHAOS``
  is unset it returns ``None`` and the hook is a single ``is None`` branch
  (same idiom as ``bulk._frame_observer`` / ``bulk.egress_bucket``).
- **Deterministic.** Every fault decision consumes one draw from a single
  seeded RNG stream under a lock, so a fixed spec + seed replays the same
  decision sequence (test-enforced in tests/test_chaos.py).
- **Accountable.** Every injected fault is logged and counted
  (``counters``, bounded ``events`` list, ``snapshot()``); a soak can prove
  faults actually fired.

The port's copy of ``opendiloco_tpu/diloco/chaos.py``: one ``ODTP_CHAOS``
spec draws the same faults in either package, and every injected fault
also lands in the port's flight recorder (``obs.blackbox``) when
``ODTP_OBS`` is armed.
"""

from __future__ import annotations

import fnmatch
import os
import random
import threading
import time
from collections import Counter
from typing import Optional

from opendiloco_torch.utils.logger import get_text_logger

log = get_text_logger(__name__)

_ENV = "ODTP_CHAOS"
_EVENTS_CAP = 4096


class ChaosSpecError(ValueError):
    """Malformed ODTP_CHAOS spec."""


def _parse_range(val: str) -> tuple[float, float]:
    if ".." in val:
        lo, hi = val.split("..", 1)
        lo_f, hi_f = float(lo), float(hi)
    else:
        lo_f = hi_f = float(val)
    if lo_f > hi_f or lo_f < 0:
        raise ChaosSpecError(f"bad range {val!r} (need 0 <= lo <= hi)")
    return lo_f, hi_f


def _parse_rounds(val: str) -> list[int]:
    out = []
    for item in val.split(","):
        item = item.strip().lstrip("rR")
        if item:
            out.append(int(item))
    return out


def _parse_kills(val: str) -> list[tuple[int, int]]:
    out = []
    for item in filter(None, (s.strip() for s in val.split(","))):
        try:
            r, w = item.split(":", 1)
            if r[:1] not in "rR" or w[:1] not in "wW":
                raise ValueError(item)
            out.append((int(r[1:]), int(w[1:])))
        except ValueError as e:
            raise ChaosSpecError(f"bad kill_worker entry {item!r} (want rR:wW)") from e
    return out


def parse_spec(spec: str) -> dict:
    """Parse the ODTP_CHAOS grammar into a normalized parameter dict."""
    p = {
        "seed": 0,
        "drop_conn": 0.0,
        "truncate": 0.0,
        "delay_ms": (0.0, 0.0),
        "delay_p": 1.0,
        "kill_worker": [],
        "blackout_rdv": [],
        "blackout_s": 3.0,
        "straggle_ms": (0.0, 0.0),
        "straggle_inner_ms": (0.0, 0.0),
        # rank -> sustained inner-step slowdown factor; key None holds a
        # scalar factor scoped by "workers" (empty scope = every rank)
        "straggle_inner_x": {},
        "workers": [],
        "straggle_worker": None,
        "egress_bps": 0.0,
        "wan_bps": 0.0,
        "wan_peers": [],
    }
    for item in filter(None, (s.strip() for s in spec.split(";"))):
        if "=" not in item:
            raise ChaosSpecError(f"chaos spec item {item!r} is not key=value")
        k, v = (s.strip() for s in item.split("=", 1))
        try:
            _parse_item(p, k, v)
        except ChaosSpecError:
            raise
        except ValueError as e:
            raise ChaosSpecError(f"bad chaos spec value {k}={v!r}") from e
    return p


def _parse_item(p: dict, k: str, v: str) -> None:
    if k == "seed":
        p["seed"] = int(v)
    elif k in ("drop_conn", "truncate", "delay_p"):
        p[k] = float(v)
        if not 0.0 <= p[k] <= 1.0:
            raise ChaosSpecError(f"{k}={v} outside [0, 1]")
    elif k in ("delay_ms", "straggle_ms", "straggle_inner_ms"):
        p[k] = _parse_range(v)
    elif k == "kill_worker":
        p["kill_worker"] = _parse_kills(v)
    elif k == "blackout_rdv":
        p["blackout_rdv"] = _parse_rounds(v)
    elif k == "blackout_s":
        p["blackout_s"] = float(v)
    elif k == "straggle_inner_x":
        table: dict = {}
        for item in filter(None, (s.strip() for s in v.split(","))):
            if ":" in item:
                w, x = item.split(":", 1)
                if w[:1] not in "wW":
                    raise ChaosSpecError(
                        f"bad straggle_inner_x entry {item!r} (want wW:X)")
                table[int(w[1:])] = float(x)
            else:
                table[None] = float(item)
        if any(x < 1.0 for x in table.values()):
            raise ChaosSpecError("straggle_inner_x factors must be >= 1.0")
        p["straggle_inner_x"] = table
    elif k == "workers":
        p["workers"] = sorted(
            int(w.lstrip("wW"))
            for w in filter(None, (s.strip() for s in v.split(",")))
        )
        if not p["workers"]:
            raise ChaosSpecError("workers needs at least one rank")
    elif k == "straggle_worker":
        p["straggle_worker"] = int(v.lstrip("wW"))
    elif k in ("egress_bps", "wan_bps"):
        p[k] = float(v)
        if p[k] < 0:
            raise ChaosSpecError(f"{k}={v} must be >= 0")
    elif k == "wan_peers":
        p["wan_peers"] = [g for g in (s.strip() for s in v.split("|")) if g]
        if not p["wan_peers"]:
            raise ChaosSpecError("wan_peers needs at least one glob")
    else:
        raise ChaosSpecError(f"unknown chaos spec key {k!r}")


class ChaosPlane:
    """Process-wide fault injector. All decisions draw from one seeded RNG
    stream; counters and a bounded event log account for every injection."""

    def __init__(self, spec: str):
        self.spec = spec
        self.params = parse_spec(spec)
        self.seed = self.params["seed"]
        self._rng = random.Random(self.seed)
        self._lock = threading.Lock()
        self.counters: Counter = Counter()
        self.events: list[dict] = []
        self.identity: Optional[int] = None  # worker rank, via set_identity()
        self._rdv_rounds: list[str] = []  # distinct matchmaking keys (daemon)
        self._blackout_until = 0.0

    # -- bookkeeping ---------------------------------------------------------

    def set_identity(self, worker: int) -> None:
        """Tell the plane which worker rank this process is (scopes
        straggle_worker / should_kill to the right process)."""
        self.identity = int(worker)

    def _draw(self) -> float:
        with self._lock:
            return self._rng.random()

    def _record(self, kind: str, site: str, **detail) -> None:
        with self._lock:
            self.counters[kind] += 1
            self.counters["total"] += 1
            if len(self.events) < _EVENTS_CAP:
                self.events.append({"kind": kind, "site": site, **detail})
        log.warning("chaos: injected %s at %s %s", kind, site, detail or "")
        # every injected fault lands in the flight recorder (and, rate-
        # limited, on disk): a postmortem can then correlate faults with
        # the spans they perturbed. No-op unless ODTP_OBS is armed; lazy
        # import keeps the fault-free path free of obs machinery.
        try:
            from opendiloco_torch.obs import blackbox

            bb = blackbox.recorder()
            if bb is not None:
                bb.note_fault(kind, site, detail)
        except Exception:
            pass

    def snapshot(self) -> dict:
        """Counters + bounded event log, JSON-ready (soak/ledger reporting)."""
        with self._lock:
            return {"spec": self.spec, "counters": dict(self.counters),
                    "events": list(self.events)}

    # -- fault decisions (each consumes exactly one RNG draw when armed) -----

    def drop_conn(self, site: str) -> bool:
        p = self.params["drop_conn"]
        if p <= 0.0:
            return False
        if self._draw() < p:
            self._record("drop_conn", site)
            return True
        return False

    def truncate(self, site: str) -> bool:
        p = self.params["truncate"]
        if p <= 0.0:
            return False
        if self._draw() < p:
            self._record("truncate", site)
            return True
        return False

    def delay_s(self, site: str) -> float:
        lo, hi = self.params["delay_ms"]
        if hi <= 0.0:
            return 0.0
        if self.params["delay_p"] < 1.0 and self._draw() >= self.params["delay_p"]:
            return 0.0
        d = (lo + (hi - lo) * self._draw()) / 1000.0
        if d > 0.0:
            self._record("delay", site, ms=round(d * 1000.0, 3))
        return d

    def straggle_s(self) -> float:
        lo, hi = self.params["straggle_ms"]
        if hi <= 0.0:
            return 0.0
        w = self.params["straggle_worker"]
        if w is not None and self.identity != w:
            return 0.0
        d = (lo + (hi - lo) * self._draw()) / 1000.0
        if d > 0.0:
            self._record("straggle", "outer_round", ms=round(d * 1000.0, 3))
        return d

    def straggle_inner_s(self) -> float:
        """Slow-host emulation: seconds to sleep inside one inner training
        step (train loop hook). Consumed once per step so the worker's
        measured tokens/s — which rides the overseer roll-up — drops by
        exactly the injected factor."""
        lo, hi = self.params["straggle_inner_ms"]
        if hi <= 0.0:
            return 0.0
        w = self.params["straggle_worker"]
        if w is not None and self.identity != w:
            return 0.0
        d = (lo + (hi - lo) * self._draw()) / 1000.0
        if d > 0.0:
            self._record("straggle_inner", "inner_step", ms=round(d * 1000.0, 3))
        return d

    def straggle_inner_x(self, rank: Optional[int] = None) -> float:
        """Sustained inner-step slowdown factor for ``rank`` (1.0 = full
        speed). PURE lookup — no RNG draw, no counters: many worker
        threads in one process (loopback benches) query their own factor
        concurrently, and a draw here would perturb the deterministic
        fault stream the other injectors replay. The train-loop hook
        stretches each measured inner step by (factor - 1) of its own
        duration, so a factor of X shows up as exactly X-times-slower
        tokens/s and steps/s in the overseer roll-up."""
        table = self.params["straggle_inner_x"]
        if not table:
            return 1.0
        r = self.identity if rank is None else int(rank)
        if r in table:
            return float(table[r])
        x = table.get(None)
        if x is None:
            return 1.0
        scope = self.params["workers"]
        if scope and r not in scope:
            return 1.0
        return float(x)

    def egress_bps(self) -> float:
        """Emulated egress cap for this process (0 = none). Consumed by
        bulk.egress_bucket(), which folds it into the shared token bucket
        (lower of this and ODTP_BULK_BANDWIDTH_BPS binds) — so every
        payload path that honors the env cap honors the chaos cap too."""
        return float(self.params["egress_bps"])

    def wan_bps(self) -> float:
        """Emulated WAN-uplink cap (0 = none). Consumed by
        bulk.wan_bucket(); frames to ``is_wan_peer`` destinations drain it
        IN ADDITION to the egress bucket — a site's NIC and its shared
        uplink are separate constraints and both must bind."""
        return float(self.params["wan_bps"])

    def is_wan_peer(self, peer_id: str) -> bool:
        """Does a frame to this destination cross the emulated WAN?
        fnmatch against the wan_peers globs; no globs means no WAN
        classification (wan_bps never bites)."""
        globs = self.params["wan_peers"]
        return any(fnmatch.fnmatch(peer_id, g) for g in globs)

    # -- schedules -----------------------------------------------------------

    def kill_schedule(self) -> list[tuple[int, int]]:
        """[(round, worker_rank)] SIGKILL schedule for an orchestrator."""
        return list(self.params["kill_worker"])

    def should_kill(self, round_idx: int, worker: int) -> bool:
        return (int(round_idx), int(worker)) in set(self.params["kill_worker"])

    # -- daemon-side blackout ------------------------------------------------

    def rdv_blackout(self, round_key: Optional[str] = None) -> bool:
        """Daemon-side gate: True while the daemon should play dead.

        Distinct matchmaking round keys are counted as they arrive; when the
        count reaches an entry of ``blackout_rdv`` the daemon goes dark for
        ``blackout_s`` seconds (drops frames without replying), exercising
        worker failover + backoff. Non-matchmaking frames pass ``None`` and
        only honor an already-active blackout.
        """
        sched = self.params["blackout_rdv"]
        if not sched and self._blackout_until <= 0.0:
            return False
        now = time.monotonic()
        with self._lock:
            if round_key is not None and round_key not in self._rdv_rounds:
                self._rdv_rounds.append(round_key)
                if len(self._rdv_rounds) in sched:
                    self._blackout_until = now + self.params["blackout_s"]
                    log.warning(
                        "chaos: rendezvous blackout armed for %.1fs (round %d: %s)",
                        self.params["blackout_s"], len(self._rdv_rounds), round_key,
                    )
            active = now < self._blackout_until
        if active:
            self._record("blackout_rdv", "rendezvous", round=round_key)
        return active


# -- process-wide accessor (bulk.egress_bucket idiom) -------------------------

_plane: Optional[ChaosPlane] = None
_spec: Optional[str] = None
_plane_lock = threading.Lock()


def plane() -> Optional[ChaosPlane]:
    """The process-wide chaos plane, or None when ODTP_CHAOS is unset/empty.

    Re-reads the env var every call (one dict hit) and rebuilds only when
    the spec string changes, so hook sites stay zero-cost when disabled.
    """
    global _plane, _spec
    spec = os.environ.get(_ENV) or None
    if spec == _spec:
        return _plane
    with _plane_lock:
        if spec != _spec:
            _plane = ChaosPlane(spec) if spec else None
            _spec = spec
    return _plane


def reset() -> None:
    """Drop the cached plane so the next plane() re-parses ODTP_CHAOS
    (tests use this to get a fresh RNG stream)."""
    global _plane, _spec
    with _plane_lock:
        _plane = None
        _spec = None


def backoff_s(attempt: int, base: Optional[float] = None,
              cap: Optional[float] = None) -> float:
    """Bounded exponential backoff with jitter for round retries.

    sleep = U(0.5, 1.0) * min(cap, base * 2**attempt); knobs
    ODTP_RETRY_BASE_S (default 0.5) and ODTP_RETRY_CAP_S (default 15).
    When the chaos plane is armed its seeded RNG supplies the jitter so
    retry schedules replay deterministically under a fixed seed.
    """
    if base is None:
        base = float(os.environ.get("ODTP_RETRY_BASE_S", "0.5"))
    if cap is None:
        cap = float(os.environ.get("ODTP_RETRY_CAP_S", "15"))
    span = min(cap, base * (2 ** max(0, int(attempt))))
    p = plane()
    u = p._draw() if p is not None else random.random()
    return (0.5 + 0.5 * u) * span


def round_retries(default: int = 3) -> int:
    """How many times a failed outer round re-forms (ODTP_ROUND_RETRIES)."""
    return max(1, int(os.environ.get("ODTP_ROUND_RETRIES", str(default))))
