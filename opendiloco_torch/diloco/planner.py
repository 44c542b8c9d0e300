"""Deterministic topology planner for the outer data plane.

One module owns every partition/topology decision the transports used to
make inline: the flat butterfly's part bounds (uniform and the
capacity-proportional ``ODTP_LINK_ADAPT`` plan, migrated from
linkstate.py), the group fingerprint that keys a round, the streaming
fragment partition (migrated from optimizer.py), and — new — the
**hierarchical galaxy** plan: peers clustered into sites from the
gossiped link matrix, one aggregator elected per site, and a two-level
round (intra-site reduce-scatter over fat links, aggregators-only WAN
butterfly, intra-site broadcast) that cuts WAN bytes per round from
``O(n)`` full shares to ``O(sites)``.

Determinism is the whole contract: every planning input comes from the
``join_group`` reply (the rendezvous hands every member the identical
group snapshot, link vectors included) plus process-identical env knobs,
so identical pure-function planning yields the identical plan on every
worker. :func:`HierPlan.plan_hash` covers the site map, the elected
aggregators, both bounds levels AND the wire version; it rides every
hierarchical frame, so a worker planning a different topology (version
skew, env skew) fails the round loudly instead of mis-reducing.

Knobs (all read per call, like ``linkstate.enabled``):

- ``ODTP_HIER``       arm the two-level hierarchical round (default off;
                      with one site — or no way to split — the round
                      falls back to the flat butterfly).
- ``ODTP_SITES``      explicit site assignment override:
                      ``;``-separated sites, each a ``|``-separated list
                      of fnmatch globs over peer ids, e.g.
                      ``dc-a-*;dc-b-*``. Peers matching no site each form
                      their own singleton site. Unset = cluster
                      automatically from the gossiped link matrix.
- ``ODTP_SITE_RATIO`` automatic clustering threshold: peers stay in one
                      site while their symmetrized pair bandwidth is
                      within this factor of the fattest measured link
                      (default 4.0 — a 4x-slower link is a WAN link).
- ``ODTP_HIER_AGG``   aggregator election override: ``|``-separated
                      fnmatch globs; within each site, members matching
                      a glob are preferred aggregator candidates. No
                      live match in a site = capacity-ranked election
                      (peer-id tiebreak), which is also the default —
                      and what makes an aggregator SIGKILL an elastic
                      non-event: next round's snapshot no longer has the
                      corpse, so election deterministically lands on the
                      next-ranked member.

The port's copy of ``opendiloco_tpu/diloco/planner.py``: every member
of a mixed group, JAX or port, derives the same plan and its hash.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import hashlib
import math
import os
import statistics
from typing import Optional

import numpy as np

from opendiloco_torch.diloco import linkstate
from opendiloco_torch.diloco.schema import (
    PLAN_HASH_ALGO,
    PLAN_HASH_HEXLEN,
    WIRE_VERSION,
)


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def hier_enabled() -> bool:
    """Master switch for the two-level round; read per call."""
    return os.environ.get("ODTP_HIER", "").lower() in ("1", "true", "on")


def sites_spec() -> str:
    return os.environ.get("ODTP_SITES", "")


def agg_spec() -> str:
    return os.environ.get("ODTP_HIER_AGG", "")


def site_ratio() -> float:
    """Bandwidth factor separating intra-site links from WAN links."""
    return max(1.0, _env_float("ODTP_SITE_RATIO", 4.0))


# -- flat-butterfly partition planning (migrated from linkstate.py) -----------
#
# Planning inputs come EXCLUSIVELY from the join_group reply: the rendezvous
# materializes one group list (each member's registration + progress, links
# vector included) at round close and hands the identical copy to every
# member, so identical pure-function planning yields identical bounds on
# every worker. plan_hash() in the frame meta turns any residual divergence
# (version skew, daemon mutation) into a loud AllReduceError instead of a
# silently mis-partitioned reduce.


def group_capacities(group: list[dict]) -> Optional[list[float]]:
    """Per-member capacity estimate (bytes/s) from the shared snapshot.

    None = plan uniform: any member not speaking the link protocol (adapt
    off, older version) vetoes adaptivity for the whole group — a mixed
    swarm must agree on bounds, and uniform is the only plan every member
    can compute.

    capacity_j = min(egress_j, ingress_j) where egress_j is the median of
    j's own published goodputs toward its peers and ingress_j the median of
    what the other members measured sending TO j — the binding direction
    governs (an egress-capped straggler looks fast from outside; a
    congested ingress looks fine to its own sends).
    """
    links: list[dict] = []
    for member in group:
        vec = linkstate._member_links(member)
        if vec is None:
            return None
        links.append(vec)
    caps: list[float] = []
    for j, member in enumerate(group):
        pid = member.get("peer_id")
        egress = [
            float(ent.get("bps", 0) or 0)
            for ent in links[j].values()
            if isinstance(ent, dict)
        ]
        ingress = [
            float(ent.get("bps", 0) or 0)
            for i, vec in enumerate(links)
            if i != j
            for key, ent in vec.items()
            if key == pid and isinstance(ent, dict)
        ]
        egress = [b for b in egress if b > 0 and math.isfinite(b)]
        ingress = [b for b in ingress if b > 0 and math.isfinite(b)]
        sides = []
        if egress:
            sides.append(statistics.median(egress))
        if ingress:
            sides.append(statistics.median(ingress))
        caps.append(min(sides) if sides else 0.0)
    known = [c for c in caps if c > 0.0]
    if not known:
        return None  # nobody has measured anything yet: uniform
    # unknown links assume the median known capacity — neutral, so a fresh
    # joiner is neither starved nor trusted with an outsized part
    fill = statistics.median(known)
    return [c if c > 0.0 else fill for c in caps]


def plan_shares(caps: list[float], floor: Optional[float] = None) -> list[float]:
    """Capacity-proportional shares with a min-share floor.

    ``floor`` is a fraction of the uniform share 1/n (default
    ``ODTP_LINK_MIN_SHARE``). Shares below the floor are pinned to it and
    the remainder redistributes proportionally over the unpinned peers;
    the loop terminates in <= n passes (each pass pins >= 1 new peer).
    """
    n = len(caps)
    if n < 2:
        return [1.0] * n
    lo = (floor if floor is not None else linkstate.min_share()) / n
    total = sum(caps)
    if total <= 0.0:
        return [1.0 / n] * n
    shares = [c / total for c in caps]
    pinned: set[int] = set()
    for _ in range(n):
        low = [
            i for i in range(n) if i not in pinned and shares[i] < lo - 1e-12
        ]
        if not low:
            break
        pinned.update(low)
        if len(pinned) >= n:
            return [1.0 / n] * n
        budget = 1.0 - lo * len(pinned)
        free_total = sum(caps[i] for i in range(n) if i not in pinned)
        if budget <= 0.0 or free_total <= 0.0:
            return [1.0 / n] * n
        shares = [
            lo if i in pinned else caps[i] / free_total * budget
            for i in range(n)
        ]
    return shares


def plan_bounds(
    total_elems: int, group: list[dict], *, quantum: int = 1024
) -> Optional[np.ndarray]:
    """Butterfly part bounds for this round, or None for the uniform plan.

    Bounds are quantized to ``quantum`` elements (tidier codec chunk grids;
    the final bound always lands exactly on ``total_elems``). Tiny buffers
    (barrier probes, gossip pairs) always plan uniform: there is nothing to
    rebalance and control rounds should stay bit-stable.
    """
    n = len(group)
    if n < 2 or total_elems < n * quantum * 4:
        return None
    caps = group_capacities(group)
    if caps is None:
        return None
    shares = plan_shares(caps)
    bounds = np.zeros(n + 1, np.int64)
    acc = 0.0
    for j in range(n):
        acc += shares[j]
        b = int(round(acc * total_elems / quantum)) * quantum
        bounds[j + 1] = min(max(b, int(bounds[j])), total_elems)
    bounds[n] = total_elems
    return bounds


def plan_hash(bounds) -> str:
    """Stable fingerprint of a bounds vector, carried in every push/result
    frame meta; receivers compare against their own plan so a divergent
    partition fails the round loudly instead of corrupting the average."""
    raw = ",".join(str(int(b)) for b in bounds).encode()
    return hashlib.new(PLAN_HASH_ALGO, raw).hexdigest()[:PLAN_HASH_HEXLEN]


def shares_of(bounds, total_elems: int) -> list[float]:
    """Bounds back to rounded shares (health ledger / HEALTH lines)."""
    if total_elems <= 0:
        return []
    return [
        round(float(int(bounds[j + 1]) - int(bounds[j])) / total_elems, 4)
        for j in range(len(bounds) - 1)
    ]


# -- group identity + uniform partition (migrated from tcp.py) ----------------


def group_fingerprint(group: list[dict]) -> str:
    """Membership fingerprint suffixed onto the round key: two workers that
    matchmade into different groups for the same logical round must not
    share mailbox keys."""
    raw = ",".join(p.get("peer_id", "") for p in group).encode()
    return hashlib.sha1(raw).hexdigest()[:8]


def uniform_bounds(total_elems: int, n: int) -> np.ndarray:
    """The equal-parts butterfly partition (the codec=none bit-stable
    default every member can compute with zero link knowledge)."""
    return np.linspace(0, total_elems, n + 1).astype(np.int64)


# -- streaming fragment partition (migrated from optimizer.py) ----------------


def fragment_partition(leaf_sizes: list[int], n_frag: int) -> list[list[int]]:
    """Partition leaf indices into ``n_frag`` contiguous, size-balanced,
    non-empty fragments (the Streaming-DiLoCo fragment schedule). Greedy:
    close a fragment once it reaches the ideal share — or when the leaves
    left are exactly the fragments still needing one each.
    """
    total = sum(leaf_sizes)
    fragments: list[list[int]] = []
    current: list[int] = []
    acc = 0
    target = total / n_frag
    for i, size in enumerate(leaf_sizes):
        current.append(i)
        acc += size
        remaining = len(leaf_sizes) - (i + 1)
        still_needed = n_frag - len(fragments) - 1
        if len(fragments) < n_frag - 1 and (
            acc >= target or remaining == still_needed
        ):
            fragments.append(current)
            current = []
            acc = 0
    fragments.append(current)
    if len(fragments) != n_frag or any(not f for f in fragments):
        raise ValueError(
            f"cannot split {len(leaf_sizes)} leaves into {n_frag} "
            "non-empty fragments"
        )
    return fragments


# -- site clustering ----------------------------------------------------------


def _sites_from_spec(spec: str, peer_ids: list[str]) -> list[list[int]]:
    """ODTP_SITES override -> site member-index lists (group order inside
    each site; declared-site order, then singletons for unmatched peers)."""
    decls = [
        [g.strip() for g in site.split("|") if g.strip()]
        for site in spec.split(";")
        if site.strip()
    ]
    sites: list[list[int]] = [[] for _ in decls]
    leftovers: list[list[int]] = []
    for idx, pid in enumerate(peer_ids):
        for s, globs in enumerate(decls):
            if any(fnmatch.fnmatchcase(pid, g) for g in globs):
                sites[s].append(idx)
                break
        else:
            leftovers.append([idx])
    return [s for s in sites if s] + leftovers


def _pair_bps(group: list[dict]) -> Optional[list[list[float]]]:
    """Symmetrized pair-bandwidth matrix from the shared snapshot, or None
    when any member lacks a link vector (mixed swarm: no clustering).
    bps(i, j) = max of the two directed published estimates — one side
    measuring the link fat is enough to call it intra-site."""
    links: list[dict] = []
    for member in group:
        vec = linkstate._member_links(member)
        if vec is None:
            return None
        links.append(vec)
    ids = [m.get("peer_id", "") for m in group]
    n = len(group)
    mat = [[0.0] * n for _ in range(n)]
    for i in range(n):
        for j in range(n):
            if i == j:
                continue
            ent = links[i].get(ids[j])
            bps = float(ent.get("bps", 0) or 0) if isinstance(ent, dict) else 0.0
            if bps > 0 and math.isfinite(bps):
                mat[i][j] = max(mat[i][j], bps)
                mat[j][i] = max(mat[j][i], bps)
    return mat


def cluster_sites(group: list[dict]) -> list[list[int]]:
    """Deterministic site assignment for a group snapshot.

    ``ODTP_SITES`` set: explicit glob assignment. Otherwise: connected
    components of the link graph keeping only pairs within
    ``ODTP_SITE_RATIO`` of the fattest measured link. No measurements (or
    a mixed swarm) = one site = the flat butterfly.
    """
    peer_ids = [m.get("peer_id", "") for m in group]
    spec = sites_spec()
    if spec:
        return _sites_from_spec(spec, peer_ids)
    n = len(group)
    mat = _pair_bps(group)
    if mat is None:
        return [list(range(n))]
    peak = max((mat[i][j] for i in range(n) for j in range(i + 1, n)),
               default=0.0)
    if peak <= 0.0:
        return [list(range(n))]
    threshold = peak / site_ratio()
    parent = list(range(n))

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for i in range(n):
        for j in range(i + 1, n):
            if mat[i][j] >= threshold:
                ri, rj = find(i), find(j)
                if ri != rj:
                    parent[max(ri, rj)] = min(ri, rj)
    comps: dict[int, list[int]] = {}
    for i in range(n):
        comps.setdefault(find(i), []).append(i)
    return [comps[r] for r in sorted(comps)]


def elect_aggregator(group: list[dict], site: list[int]) -> int:
    """The site's aggregator (group index), deterministically.

    ``ODTP_HIER_AGG`` globs narrow the candidates when any live member
    matches; the pick among candidates is capacity-ranked (group-snapshot
    capacities, so every member ranks identically) with the peer id as the
    total-order tiebreak. A dead aggregator simply stops appearing in the
    snapshot, so the next round's election moves on without coordination.
    """
    candidates = list(site)
    spec = agg_spec()
    if spec:
        globs = [g.strip() for g in spec.split("|") if g.strip()]
        preferred = [
            i for i in site
            if any(
                fnmatch.fnmatchcase(group[i].get("peer_id", ""), g)
                for g in globs
            )
        ]
        if preferred:
            candidates = preferred
    caps = group_capacities(group)
    return min(
        candidates,
        key=lambda i: (
            -(caps[i] if caps else 0.0),
            group[i].get("peer_id", ""),
        ),
    )


# -- round plans --------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HierPlan:
    """The two-level round: who reduces with whom, over which bounds.

    ``hash`` covers the wire version, the full site map, the elected
    aggregators and both bounds levels — any worker whose topology inputs
    diverge derives a different hash and the round fails loudly at the
    first frame instead of folding misaligned slices.
    """

    sites: tuple[tuple[int, ...], ...]  # group indices, site-major
    aggregators: tuple[int, ...]  # one group index per site
    intra_bounds: tuple[tuple[int, ...], ...]  # per site: flat partition
    wan_bounds: tuple[int, ...]  # flat partition among aggregators
    hash: str
    site_of: dict[str, int]  # peer_id -> site index

    @property
    def n_sites(self) -> int:
        return len(self.sites)


@dataclasses.dataclass(frozen=True)
class RoundPlan:
    """Everything one outer round needs from the planner."""

    fingerprint: str  # group-membership fp (round-key suffix)
    bounds: np.ndarray  # flat butterfly part bounds
    plan_meta: dict  # stamped into push/result frame meta
    health: dict  # extras for the round-health ledger
    site_of: Optional[dict[str, int]]  # topology view (also when flat)
    hier: Optional[HierPlan]  # None = flat butterfly round


def _hier_hash(
    group: list[dict],
    sites: list[list[int]],
    aggs: list[int],
    intra: list[np.ndarray],
    wan: np.ndarray,
) -> str:
    ids = [m.get("peer_id", "") for m in group]
    parts = [f"v{WIRE_VERSION}"]
    for s, site in enumerate(sites):
        parts.append(
            ",".join(ids[i] for i in site)
            + ">" + ids[aggs[s]]
            + "@" + ",".join(str(int(b)) for b in intra[s])
        )
    parts.append(",".join(str(int(b)) for b in wan))
    raw = "|".join(parts).encode()
    return hashlib.new(PLAN_HASH_ALGO, raw).hexdigest()[:PLAN_HASH_HEXLEN]


def plan_round(
    group: list[dict],
    total_elems: int,
    *,
    adaptive: bool = False,
    hier: Optional[bool] = None,
) -> RoundPlan:
    """Plan one outer round from the shared group snapshot.

    Flat path: the exact planning tcp.py used to do inline — adaptive
    ``plan_bounds`` when armed and agreed, else uniform. The plan hash is
    stamped on every frame whenever the adaptive plane is armed (even if
    the plan fell back to uniform — a peer that disagrees about THAT is
    exactly what the hash exists to catch); non-adaptive flat frames stay
    byte-identical to the pre-planner wire. Hierarchical path: cluster,
    elect, and derive both bounds levels; degenerates to flat when the
    group cannot split into >= 2 sites.
    """
    n = len(group)
    fp = group_fingerprint(group)
    bounds = plan_bounds(total_elems, group) if adaptive else None
    plan_meta: dict = {}
    health: dict = {}
    if bounds is None:
        bounds = uniform_bounds(total_elems, n)
    if adaptive:
        plan_meta = {"plan": plan_hash(bounds)}
        health = {
            "link_plan": plan_meta["plan"],
            "link_shares": shares_of(bounds, total_elems),
        }
    if hier is None:
        hier = hier_enabled()
    sites = cluster_sites(group) if (hier or sites_spec()) and n >= 2 else None
    site_of = None
    if sites is not None and len(sites) >= 2:
        ids = [m.get("peer_id", "") for m in group]
        site_of = {
            ids[i]: s for s, site in enumerate(sites) for i in site
        }
    hp = None
    if hier and site_of is not None:
        aggs = [elect_aggregator(group, site) for site in sites]
        intra = [
            uniform_bounds(total_elems, len(site)) for site in sites
        ]
        wan = uniform_bounds(total_elems, len(sites))
        hp = HierPlan(
            sites=tuple(tuple(s) for s in sites),
            aggregators=tuple(aggs),
            intra_bounds=tuple(tuple(int(b) for b in ib) for ib in intra),
            wan_bounds=tuple(int(b) for b in wan),
            hash=_hier_hash(group, sites, aggs, intra, wan),
            site_of=site_of,
        )
        plan_meta = dict(plan_meta)
        plan_meta["plan"] = hp.hash
        health = dict(health)
        ids = [m.get("peer_id", "") for m in group]
        health["hier"] = {
            "sites": [[ids[i] for i in site] for site in sites],
            "aggregators": [ids[a] for a in aggs],
            "plan": hp.hash,
        }
    return RoundPlan(
        fingerprint=fp,
        bounds=bounds,
        plan_meta=plan_meta,
        health=health,
        site_of=site_of,
        hier=hp,
    )
