"""Barrier-free NoLoCo gossip outer rounds (arXiv 2506.10911).

The port's copy of ``opendiloco_tpu/diloco/gossip.py``. Gossip replaces
the global outer collective with one pairwise exchange per (epoch,
fragment): every worker derives the SAME pairing locally from a shared
epoch-keyed PRNG over the sorted live membership, with no rendezvous
round, no barrier and no matchmaking messages. Two paired workers push
their (master, momentum, pseudo-gradient) fragment to each other on the
backend's ``pair_exchange`` and mix; the NoLoCo modified Nesterov step is
then a plain Nesterov step on the MIXED state with the pair-averaged
pseudo-gradient (:func:`~opendiloco_torch.diloco.outer_optimizer.noloco_step`).

Agreement without messages::

    pair_schedule(sorted(members), key)   key = f"f{frag}-e{epoch}"

seeds ``random.Random`` with a string (hashed through sha512, the same in
every process and in either package), so a port worker and a JAX worker
with the same membership view compute the same pairing. Views may differ
for a moment under churn: the two sides of a mismatched pair then wait on
different round keys, time out and drop the round, which is a non-event
(the residual stays, the params keep their local progress, the next epoch
pairs again).

Link-aware draws: published link vectors bias the partner draw toward
fast pairs. Capacities are bucketed to powers of two before weighting, so
an EWMA's last digit cannot split two workers' schedules, and a weight
floor keeps every pair drawable.

An odd galaxy self-pairs exactly one worker a round: policy "nesterov"
(the default) steps on its own state, "hold" skips the round.

Async rounds (``ODTP_ASYNC_STALENESS`` > 0) drop the shared key: at each
of its own epoch boundaries a worker asks the backend for ANY partner on
the same fragment within the staleness window
(``backend.async_pair_match``), swaps fragments under the match key on
the same ``pair_exchange`` wire and mixes with a staleness-discounted
weight (bit for bit the lockstep mix at distance 0). No partner within
``ODTP_ASYNC_PATIENCE_S`` means a self-round by the policy above.

Masters and momentum ride the state codec (fp16 family), pseudo-gradients
the configured codec, with error-feedback residuals per PARTNER: the mass
a lossy codec drops toward partner A is replayed the next time A is
drawn. Every mixing op is numpy f32 in the sorted-pair operand order, so
both ends of a pair, of either package, hold the same bits. Armed
(``ODTP_OBS``), every round reports what the JAX package reports:
``record_wire("gossip", raw, wire)``, the ``outer/gossip_pair`` span, the
``outer/round`` record, the ``gossip_pair_s`` gauge, the pair, round,
dropped and wire counters, and the overseer's ``note_round``.
"""
from __future__ import annotations

import asyncio
import hashlib
import math
import os
import random
import threading
import time
from typing import Optional

import numpy as np

from opendiloco_torch import obs
from opendiloco_torch.diloco.backend import AllReduceError
from opendiloco_torch.diloco.compression import get_codec, record_wire
from opendiloco_torch.diloco.error_feedback import ErrorFeedback
from opendiloco_torch.diloco.outer_optimizer import staleness_mix, staleness_weight
from opendiloco_torch.diloco.state_io import state_codec
from opendiloco_torch.utils.logger import get_text_logger

log = get_text_logger(__name__)

_HEALTH_LEDGER_CAP = 256


# -- knobs ---------------------------------------------------------------------


def gossip_seed() -> int:
    """ODTP_GOSSIP_SEED: the shared pairing seed (the same galaxy-wide)."""
    return int(os.environ.get("ODTP_GOSSIP_SEED", "0") or 0)


def link_bias() -> float:
    """ODTP_GOSSIP_LINK_BIAS: exponent on the normalized pair capacity when
    drawing partners (0 turns link awareness off)."""
    return float(os.environ.get("ODTP_GOSSIP_LINK_BIAS", "1.0") or 1.0)


def link_floor() -> float:
    """ODTP_GOSSIP_LINK_FLOOR: the slowest pair's least relative draw
    weight, so every pair stays reachable."""
    return float(os.environ.get("ODTP_GOSSIP_LINK_FLOOR", "0.25") or 0.25)


def self_round_policy() -> str:
    """ODTP_GOSSIP_SELF_ROUND: "nesterov" steps a self-paired worker on its
    own state (the default), "hold" skips the round."""
    return os.environ.get("ODTP_GOSSIP_SELF_ROUND", "nesterov") or "nesterov"


def async_staleness() -> int:
    """ODTP_ASYNC_STALENESS: the async window in outer epochs; 0 (the
    default) keeps the lockstep per-(epoch, fragment) pairing."""
    return int(os.environ.get("ODTP_ASYNC_STALENESS", "0") or 0)


def async_decay() -> float:
    """ODTP_ASYNC_DECAY: the discount of a staler partner's weight per
    epoch of distance (weight = 0.5 * decay**d)."""
    return float(os.environ.get("ODTP_ASYNC_DECAY", "0.5") or 0.5)


def async_patience_s() -> float:
    """ODTP_ASYNC_PATIENCE_S: how long a worker waits for an in-window
    partner before it steps alone."""
    return float(os.environ.get("ODTP_ASYNC_PATIENCE_S", "2.0") or 2.0)


# -- pair scheduling -----------------------------------------------------------


def _pair_key(a: str, b: str) -> tuple[str, str]:
    return (a, b) if a <= b else (b, a)


def pair_schedule(members, key: str, *, weights: Optional[dict] = None, seed: int = 0) -> dict[str, str]:
    """The pairing of ``members`` for round ``key``: a symmetric map id ->
    partner over every member; with an odd count exactly one member maps
    to itself. ``weights`` (optional) maps ``_pair_key(a, b)`` to a
    relative draw weight."""
    pool = sorted(set(members))
    rng = random.Random(f"odtp-gossip:{int(seed)}:{key}")
    pairs: dict[str, str] = {}
    while pool:
        a = pool.pop(0)
        if not pool:
            pairs[a] = a  # the odd one out: a self-round
            break
        if weights:
            w = [max(float(weights.get(_pair_key(a, x), 1.0)), 1e-9) for x in pool]
            b = rng.choices(pool, weights=w)[0]
        else:
            b = pool[rng.randrange(len(pool))]
        pool.remove(b)
        pairs[a] = b
        pairs[b] = a
    return pairs


def link_pair_weights(matrix: Optional[dict], members) -> Optional[dict[tuple[str, str], float]]:
    """Pair draw weights from the gossiped link matrix: each pair's bps
    bucketed to a power of two, weight max(floor, (bucket / top) ** bias);
    an unmeasured link weighs 1.0. None without a matrix or a bias."""
    bias = link_bias()
    if not matrix or bias <= 0:
        return None
    floor = max(0.0, min(1.0, link_floor()))
    ids = sorted(set(members))
    buckets: dict[tuple[str, str], Optional[int]] = {}
    top = 0
    for i, a in enumerate(ids):
        for b in ids[i + 1:]:
            bps = pair_bps(matrix, a, b)
            if bps and bps > 0:
                bk = 1 << max(0, int(math.log2(bps)))
                buckets[(a, b)] = bk
                top = max(top, bk)
            else:
                buckets[(a, b)] = None
    if top <= 0:
        return None
    return {k: 1.0 if bk is None else max(floor, (bk / top) ** bias) for k, bk in buckets.items()}


def pair_bps(matrix: dict, a: str, b: str) -> Optional[float]:
    """A pair's capacity from a link matrix ({pid: {"v", "peers": {pid:
    {"bps", ...}}}}): the larger of the two directions published."""
    vals = []
    for x, y in ((a, b), (b, a)):
        vec = matrix.get(x)
        if not isinstance(vec, dict):
            continue
        ent = (vec.get("peers") or {}).get(y)
        if isinstance(ent, dict):
            bps = ent.get("bps")
            if bps:
                vals.append(float(bps))
    return max(vals) if vals else None


# -- wire sections -------------------------------------------------------------


def _encode_leaves(codec, arrays) -> tuple[list[bytes], list[dict], int]:
    chunks: list[bytes] = []
    metas: list[dict] = []
    raw = 0
    for a in arrays:
        flat = np.ascontiguousarray(np.asarray(a, np.float32).reshape(-1))
        payload, meta = codec.encode(flat)
        b = bytes(payload)
        chunks.append(b)
        metas.append({"shape": list(np.shape(a)), "meta": meta, "len": len(b)})
        raw += flat.nbytes
    return chunks, metas, raw


def _decode_section(codec, metas, payload, off: int) -> tuple[list[np.ndarray], int]:
    out: list[np.ndarray] = []
    for m in metas:
        n = int(m["len"])
        raw = payload[off:off + n]
        shape = tuple(int(s) for s in m["shape"])
        size = int(np.prod(shape)) if shape else 1
        a = np.asarray(codec.decode(raw, (size,), m["meta"]), np.float32).reshape(shape)
        out.append(np.array(a, np.float32))  # owned and writeable
        off += n
    return out, off


def _avg_sorted(first, second) -> list[np.ndarray]:
    # both sides add in the same (sorted-pair) operand order, so the mixed
    # state is the same bits on both ends
    return [(x + y) * np.float32(0.5) for x, y in zip(first, second)]


def _mix_pair(own: str, partner: str, mine, theirs):
    """(mix_m, mix_b, avg_g) of a pair round, sorted-pair order."""
    first, second = (mine, theirs) if own == min(own, partner) else (theirs, mine)
    mix_b = None if mine[1] is None or theirs[1] is None else _avg_sorted(first[1], second[1])
    return _avg_sorted(first[0], second[0]), mix_b, _avg_sorted(first[2], second[2])


# -- the plane -----------------------------------------------------------------


class GossipPlane:
    """One worker's gossip state: the pairing inputs, per-partner error
    feedback, the wire encode and decode and the round health. One per
    DiLoCoOptimizer; ``exchange`` is thread-safe (streaming calls it from
    its comm threads)."""

    def __init__(self, backend, n_leaves: int, *, compression: str = "none", error_feedback: bool = False):
        self.backend = backend
        self.n_leaves = int(n_leaves)
        self.codec = get_codec(compression)
        # masters and momentum are weights: they ride the state codec, as
        # a peer's state fetch does
        self.state_codec = state_codec(self.codec)
        self.error_feedback = bool(error_feedback)
        self.seed = gossip_seed()
        self.self_policy = self_round_policy()
        self._ef: dict[str, ErrorFeedback] = {}
        self._ef_lock = threading.Lock()

    # -- per-partner error feedback ----------------------------------------

    def _ef_for(self, partner: str) -> ErrorFeedback:
        with self._ef_lock:
            ef = self._ef.get(partner)
            if ef is None:
                ef = ErrorFeedback(self.codec, self.n_leaves)
                self._ef[partner] = ef
        return ef

    def abort_all(self) -> None:
        with self._ef_lock:
            efs = list(self._ef.values())
        for ef in efs:
            ef.abort_all()

    def host_state(self) -> Optional[dict]:
        """The checkpoint's payload: partner id -> per-leaf residuals."""
        with self._ef_lock:
            items = list(self._ef.items())
        out = {}
        for pid, ef in items:
            res = ef.host_residuals()
            if res is not None:
                out[pid] = res
        return out or None

    def load(self, state: Optional[dict]) -> None:
        if not state:
            return
        for pid, res in state.items():
            self._ef_for(pid).load(res)

    def residual_mass(self) -> float:
        """Total |residual| over every partner."""
        total = 0.0
        with self._ef_lock:
            efs = list(self._ef.values())
        for ef in efs:
            for r in ef.residual:
                if r is not None:
                    total += float(np.abs(r, dtype=np.float64).sum())
        return total

    # -- scheduling --------------------------------------------------------

    def round_pairs(self, members, links, key: str) -> dict[str, str]:
        weights = link_pair_weights(links, members)
        return pair_schedule(members, key, weights=weights, seed=self.seed)

    def _self_round(self, key, t0, masters, bufs, pgs):
        """The self-paired (or unmatched) worker: its own state as f32
        copies, no codec; None under "hold"."""
        own = self.backend.peer_id
        if self.self_policy == "hold":
            self._record(key, partner=own, n=0, t0=t0, dropped=True)
            return None
        mix_m = [np.array(m, np.float32) for m in masters]
        mix_b = None if bufs is None else [np.array(b, np.float32) for b in bufs]
        avg_g = [np.array(g, np.float32) for g in pgs]
        self._record(key, partner=own, n=1, t0=t0)
        return mix_m, mix_b, avg_g, own, 1

    # -- the round ---------------------------------------------------------

    def exchange(self, *, epoch: int, frag_id: int, idxs, masters: list[np.ndarray],
                 bufs: Optional[list[np.ndarray]], pgs: list[np.ndarray], timeout: Optional[float] = None):
        """One pair round for fragment ``frag_id`` at outer ``epoch`` over
        the fragment's host f32 leaves (``bufs`` None without momentum).
        Returns ``(mix_m, mix_b, avg_g, partner, n)``, the pair-mixed
        master and momentum and the pair-averaged pseudo-gradient, ready
        for ``noloco_step``; or None when the round dropped (a partner's
        death, a timeout, a "hold" self-round): the residual stays and
        nothing is adopted."""
        t0 = time.perf_counter()
        window = async_staleness()
        if window > 0:
            return self._exchange_async(epoch=int(epoch), frag_id=int(frag_id), idxs=idxs, masters=masters,
                                        bufs=bufs, pgs=pgs, timeout=timeout, t0=t0, window=window)
        key = f"f{int(frag_id)}-e{int(epoch)}"
        members, links = self.backend.gossip_view()
        own = self.backend.peer_id
        members = set(members)
        members.add(own)
        partner = self.round_pairs(members, links, key).get(own, own)
        if partner == own:
            return self._self_round(key, t0, masters, bufs, pgs)
        lo, hi = sorted((own, partner))
        fp = hashlib.sha1(f"{key}|{lo}|{hi}|{self.seed}".encode()).hexdigest()[:12]
        return self._pair_round(key, f"gossip-{key}:{fp}", partner, idxs, masters, bufs, pgs, timeout, t0,
                                lag=None)

    def _pair_round(self, key, round_key, partner, idxs, masters, bufs, pgs, timeout, t0, *, lag):
        """Error feedback, the transfer and the mix of one matched pair."""
        own = self.backend.peer_id
        ef = self._ef_for(partner) if self.error_feedback else None
        # error feedback adds the residual into the pg in place: owned copies
        gs = [np.array(np.asarray(g, np.float32)) for g in pgs]
        if ef is not None:
            ef.prepare(round_key, idxs, gs)
        try:
            mine, theirs, wire, raw = self._transfer_and_decode(partner=partner, round_key=round_key,
                                                                masters=masters, bufs=bufs, gs=gs, timeout=timeout)
        except (AllReduceError, TimeoutError, asyncio.TimeoutError, OSError, KeyError, ValueError) as e:
            if ef is not None:
                ef.abort(round_key)
            log.warning("%sgossip round dropped (%s partner %s%s): %s", "async " if lag is not None else "", key,
                        partner, "" if lag is None else f" lag {lag}", e)
            self._record(key, partner=partner, n=0, t0=t0, dropped=True, lag=lag)
            return None
        if not lag:
            # distance 0 is the lockstep pair mix, bit for bit
            mix_m, mix_b, avg_g = _mix_pair(own, partner, mine, theirs)
        else:
            # staleness-discounted convex mix: both sides computed the same
            # distance, so the two updates still sum to the pair's sum
            wgt = staleness_weight(lag, async_decay())
            mix_m = staleness_mix(mine[0], theirs[0], wgt)
            mix_b = None if mine[1] is None or theirs[1] is None else staleness_mix(mine[1], theirs[1], wgt)
            avg_g = staleness_mix(mine[2], theirs[2], wgt)
        if ef is not None:
            ef.commit(round_key)
        record_wire("gossip", raw, wire)
        self._record(key, partner=partner, n=2, t0=t0, wire=wire, lag=lag)
        return mix_m, mix_b, avg_g, partner, 2

    def _transfer_and_decode(self, *, partner: str, round_key: str, masters: list[np.ndarray],
                             bufs: Optional[list[np.ndarray]], gs: list[np.ndarray], timeout: Optional[float]):
        """Encode own (m, b, g) sections, swap frames with ``partner`` under
        ``round_key``, decode BOTH sides through the codecs (own bytes too,
        so the two ends mix the same operands). Returns ``((mine_m, mine_b,
        mine_g), (theirs_m, theirs_b, theirs_g), wire_bytes, raw_bytes)``;
        raises on a failed transfer."""
        m_chunks, m_metas, raw_m = _encode_leaves(self.state_codec, masters)
        if bufs is not None:
            b_chunks, b_metas, raw_b = _encode_leaves(self.state_codec, bufs)
        else:
            b_chunks, b_metas, raw_b = [], None, 0
        g_chunks, g_metas, raw_g = _encode_leaves(self.codec, gs)
        payload = b"".join(m_chunks + b_chunks + g_chunks)
        meta = {
            "gossip": 1,
            "sections": {"m": m_metas, "b": b_metas, "g": g_metas},
            "codec": {"state": self.state_codec.name, "grad": self.codec.name},
        }
        p_meta, p_payload = self.backend.pair_exchange(payload, meta, partner_id=partner, round_key=round_key,
                                                       timeout=timeout)
        mine_m, off = _decode_section(self.state_codec, m_metas, payload, 0)
        mine_b: Optional[list[np.ndarray]] = None
        if b_metas is not None:
            mine_b, off = _decode_section(self.state_codec, b_metas, payload, off)
        mine_g, _ = _decode_section(self.codec, g_metas, payload, off)

        p_sections = p_meta["sections"]
        p_state = get_codec(p_meta["codec"]["state"])
        p_grad = get_codec(p_meta["codec"]["grad"])
        theirs_m, poff = _decode_section(p_state, p_sections["m"], p_payload, 0)
        theirs_b: Optional[list[np.ndarray]] = None
        if p_sections.get("b") is not None:
            theirs_b, poff = _decode_section(p_state, p_sections["b"], p_payload, poff)
        theirs_g, _ = _decode_section(p_grad, p_sections["g"], p_payload, poff)
        if len(theirs_m) != len(mine_m) or len(theirs_g) != len(mine_g):
            raise AllReduceError(
                f"gossip section mismatch with {partner}: {len(theirs_m)}/{len(theirs_g)} leaves vs "
                f"{len(mine_m)}/{len(mine_g)}"
            )
        return (mine_m, mine_b, mine_g), (theirs_m, theirs_b, theirs_g), len(payload), raw_m + raw_b + raw_g

    def _exchange_async(self, *, epoch: int, frag_id: int, idxs, masters: list[np.ndarray],
                        bufs: Optional[list[np.ndarray]], pgs: list[np.ndarray], timeout: Optional[float],
                        t0: float, window: int):
        """One free-running pair round under the staleness window: the
        backend matches this worker with any partner on the same fragment
        within ``window`` epochs, or with nobody after patience (then the
        self-round policy applies). The transfer rides ``pair_exchange``
        under the match key both sides were handed."""
        key = f"af{frag_id}-e{epoch}"
        match = self.backend.async_pair_match(frag_id=frag_id, epoch=epoch, window=window,
                                              patience=async_patience_s())
        if match is None:
            # nobody in the window within patience: step alone, the bound
            # that keeps a fast worker off the slowest worker's clock
            return self._self_round(key, t0, masters, bufs, pgs)
        partner, p_epoch, round_key = match
        dist = abs(int(epoch) - int(p_epoch))
        return self._pair_round(key, round_key, partner, idxs, masters, bufs, pgs, timeout, t0, lag=dist)

    # -- health ------------------------------------------------------------

    def _record(self, key: str, *, partner: str, n: int, t0: float, wire: int = 0, dropped: bool = False,
                lag: Optional[int] = None) -> None:
        t1 = time.perf_counter()
        health = {
            "round": f"gossip-{key}",
            "group_size": n,
            # a pair round's full group is the pair
            "expected": 2 if partner != self.backend.peer_id else 1,
            "elastic": dropped,
            "retries": 0,
            "gossip": True,
            "partner": partner,
            "pair_s": round(t1 - t0, 6),
        }
        if dropped:
            health["dropped"] = True
        if wire:
            health["wire_bytes"] = int(wire)
        if lag is not None:
            health["pair_lag"] = int(lag)  # epoch distance of an async match
        try:
            self.backend.last_round_health = health
            led = self.backend.round_ledger
            led.append(health)
            if len(led) > _HEALTH_LEDGER_CAP:
                del led[:-_HEALTH_LEDGER_CAP]
        except AttributeError:
            pass
        tr = obs.tracer()
        if tr is not None:
            tr.add_span("outer/gossip_pair", t0, t1, partner=partner, round=health["round"], dropped=dropped)
            tr.instant("outer/round", worker=self.backend.peer_id, **health)
            tr.gauge("gossip_pair_s", t1 - t0)
            tr.count("gossip_pair_rounds")
            tr.count("outer_rounds")
            if dropped:
                tr.count("gossip_dropped_rounds")
            if wire:
                tr.count("gossip_wire_bytes", wire)
        ov = obs.overseer.plane()
        if ov is not None:
            ov.note_round(health, own_id=self.backend.peer_id)
