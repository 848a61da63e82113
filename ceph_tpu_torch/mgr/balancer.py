"""Upmap balancer: even out PGs/OSD by emitting pg_upmap_items.

The mgr balancer module's upmap mode (src/pybind/mgr/balancer,
OSDMap::calc_pg_upmaps): compute the full cluster's PG->OSD mapping,
find the most over/under-full devices, and emit (from, to) upmap items
that move single replicas while respecting the failure domain (no two
replicas of a pg on one host).  The full-cluster mapping recompute is
the `OSDMapMapping`/ParallelPGMapper job (src/osd/OSDMapMapping.h:175)
-- served here by the shared epoch-memoized placement cache
(mon/pg_mapping.py): one K5 launch a pool on the card when the map fits
the bulk mapper, a batched scalar sweep otherwise, identical to what
clients are routed by.

Port of ``ceph_tpu/mgr/balancer.py``, copied: the same plans from the
same table.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

from ..crush.types import CRUSH_ITEM_NONE


def _osd_hosts(osdmap) -> dict[int, int]:
    """osd -> host bucket id, from the crush hierarchy."""
    hosts: dict[int, int] = {}
    for b in osdmap.crush.buckets.values():
        for item in b.items:
            if item >= 0:
                hosts[item] = b.id
    return hosts


def full_mapping(osdmap) -> dict[str, list[int]]:
    """pgid -> UP set for every pg of every pool, straight from the
    epoch-memoized placement cache (mon/pg_mapping.py).

    This used to run its own CRUSH sweep WITHOUT the upmap/down-osd
    filtering clients apply, so the balancer scored a mapping nobody
    was actually served from.  Now it reads the exact table
    Objecter.calc_target reads (holes are -1 after normalization)."""
    return {f"{pool_id}.{pg:x}": list(up)
            for pool_id, pg, up, _acting
            in osdmap.placement_cache().iter_all()}


def _counts_of(mapping, eligible) -> dict[int, int]:
    counts: dict[int, int] = defaultdict(int)
    for osds in mapping.values():
        for o in osds:
            if 0 <= o != CRUSH_ITEM_NONE:
                counts[o] += 1
    for o in eligible:
        counts.setdefault(o, 0)
    return counts


def _summary(counts) -> dict:
    vals = list(counts.values()) or [0]
    return {"per_osd": dict(sorted(counts.items())),
            "max": max(vals), "min": min(vals),
            "stddev": round(float(np.std(vals)), 3)}


def _eligible(osdmap) -> list[int]:
    """Balance candidates: up, in, and CRUSH-weighted (a reweight-0
    OSD is being drained -- it must never become a move target)."""
    return [o for o, i in osdmap.osds.items()
            if i.up and i.in_cluster and i.weight > 0]


def pg_distribution(osdmap) -> dict:
    """PGs-per-OSD histogram summary (for before/after comparison)."""
    return _summary(_counts_of(full_mapping(osdmap),
                               _eligible(osdmap)))


def balance(osdmap, max_moves: int = 10) -> dict:
    """One balancer pass: greedy upmap moves from the fullest OSD to
    the emptiest eligible one until balanced or out of moves.

    Eligible target: up+in+weighted, not already in the pg, and on a
    host no other member of the pg occupies (the failure-domain part of
    OSDMap::try_pg_upmap's re-validation; device-class/root constraints
    are not modelled).  Returns {"plans", "before", "after"} from ONE
    full-cluster mapping compute.
    """
    mapping = full_mapping(osdmap)
    hosts = _osd_hosts(osdmap)
    candidates = _eligible(osdmap)
    counts = _counts_of(mapping, candidates)
    before = _summary(counts)
    plans: dict[str, list] = {}
    for _ in range(max_moves):
        order = sorted(candidates, key=lambda o: counts[o])
        low, high = order[0], order[-1]
        if counts[high] - counts[low] <= 1:
            break                     # balanced
        moved = False
        for pgid, osds in mapping.items():
            if high not in osds or low in osds or pgid in plans:
                continue
            others = [o for o in osds
                      if o >= 0 and o not in (high, CRUSH_ITEM_NONE)]
            if hosts.get(low) in {hosts.get(o) for o in others}:
                continue              # would stack replicas on a host
            plans[pgid] = [(high, low)]
            mapping[pgid] = [low if o == high else o for o in osds]
            counts[high] -= 1
            counts[low] += 1
            moved = True
            break
        if not moved:
            break                     # no legal move left
    return {"plans": plans, "before": before,
            "after": _summary(counts)}


def compute_upmaps(osdmap, max_moves: int = 10) -> dict[str, list]:
    return balance(osdmap, max_moves)["plans"]


def compact_items(existing: list, new: list) -> list:
    """Fold new upmap items into an existing chain: (a,b)+(b,c)->(a,c),
    identities drop (OSDMap::calc_pg_upmaps resolves chains the same
    way so per-pg item lists do not grow without bound)."""
    items = [tuple(i) for i in existing]
    for frm, to in (tuple(i) for i in new):
        for idx, (x, y) in enumerate(items):
            if y == frm:
                frm = x
                items.pop(idx)
                break
        if frm != to:
            items.append((frm, to))
    return [list(i) for i in items]
