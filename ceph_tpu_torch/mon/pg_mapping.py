"""Bulk PG->OSD placement: one K5 launch per (map, rule) at a map epoch.

Port of ``ceph_tpu/mon/pg_mapping.py``'s bulk half (``bulk_crush``,
``pool_pps`` and the shared compiled-mapper cache).  The reference never
runs CRUSH per client op: OSDMapMapping (src/osd/OSDMapMapping.h:175)
holds the whole pg->osd table, recomputed in bulk whenever a new map epoch
lands.  Here the recompute of a (map, rule) over all its seeds is one
``VectorCrush`` launch on the card (kernel K5) when the map's shape is one
K5 takes, and a scalar sweep (``crush/mapper.py``) otherwise.

The table itself (``PGMapping``: upmap, up/down filtering, pg_temp,
deltas) needs the OSDMap, which the port does not have yet.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np

from ..crush import crush_do_rule
from ..crush.hashes import crush_hash32_2_np
from ..crush.state import crush_to_dict
from ..crush.types import CRUSH_ITEM_NONE
from ..crush.vectorized import VectorCrush
from ..device import resolve_device

# below this many lanes (sum of pg_num over same-rule pools) the bulk
# mapper's set-up (tables to the card, a kernel build on first use) is not
# worth it -- the scalar sweep wins on the small maps of unit tests.  Large
# maps (the bench, real clusters) clear it easily.
FUSED_MIN_LANES = int(os.environ.get("CEPH_TPU_PLACEMENT_FUSED_MIN",
                                     "2048"))

# structurally-identical maps share ONE mapper process-wide (bounded: stale
# structures age out): an in-process cluster runs one CrushMap object per
# daemon, all deserialized from the same mon map.
_VC_SHARED: dict[tuple, VectorCrush] = {}
_VC_SHARED_MAX = 8


def _crush_digest(crush_map) -> str:
    """Structural fingerprint of a CrushMap (buckets/rules/tunables/
    choose_args), cached on the object (maps are replaced wholesale on
    change, never mutated in place)."""
    dig = crush_map.__dict__.get("_structure_digest")
    if dig is None:
        # choose_args are baked into the mapper (CompiledMap.from_map falls
        # back to map.choose_args) but are NOT part of crush_to_dict --
        # digest them explicitly
        blob = json.dumps(
            {"crush": crush_to_dict(crush_map),
             "choose_args": getattr(crush_map, "choose_args", None)},
            sort_keys=True, default=str)
        dig = hashlib.sha256(blob.encode()).hexdigest()
        crush_map.__dict__["_structure_digest"] = dig
    return dig


def _cache_key(crush_map, ruleno: int, device) -> tuple:
    ca = getattr(crush_map, "choose_args", None)
    return (ruleno, id(ca) if ca else None, str(device))


def _vector_crush_for(crush_map, ruleno: int, device=None) -> VectorCrush:
    """The VectorCrush of a (map, rule) on ``device``, shared two ways: per
    CrushMap object (its tables stay on the card across weight-only
    epochs), and across structurally-identical maps process-wide.  Raises
    ValueError, before any launch, for a map shape K5 does not take."""
    dev = resolve_device(device)
    cache = crush_map.__dict__.setdefault("_vc_cache", {})
    key = _cache_key(crush_map, ruleno, dev)
    if key not in cache:
        shared_key = (_crush_digest(crush_map), ruleno, str(dev))
        vc = _VC_SHARED.get(shared_key)
        if vc is None:
            vc = VectorCrush(crush_map, ruleno, device=dev)
            while len(_VC_SHARED) >= _VC_SHARED_MAX:
                _VC_SHARED.pop(next(iter(_VC_SHARED)))
            _VC_SHARED[shared_key] = vc
        cache[key] = vc
    return cache[key]


def bulk_crush(crush_map, ruleno: int, xs, numrep: int, weights,
               fused: str = "auto", min_lanes: int | None = None,
               device=None) -> tuple[np.ndarray, bool]:
    """Map every x in ``xs`` through one rule: (rows, used_fused).

    rows is (len(xs), numrep) int64 with CRUSH_ITEM_NONE holes -- the raw
    result vector, before any OSDMap-level filtering.  ``fused``: 'auto'
    takes the bulk mapper (K5 on the card, its plain version with
    ``device="cpu"``) when the lane count clears ``min_lanes`` or the (map,
    rule) already has a mapper, and the map's shape is one it takes;
    'always' forces it (raising ValueError if the shape is refused);
    'never' is the pure scalar sweep.  A kernel build or launch failure is
    a RuntimeError and propagates.
    """
    dev = resolve_device(device)
    xs = np.asarray(xs, dtype=np.int64)
    lanes = int(xs.shape[0])
    threshold = FUSED_MIN_LANES if min_lanes is None else min_lanes
    # a warm mapper for this (map, rule) makes the bulk launch all but free:
    # the threshold only guards its one-time set-up
    warm = (_cache_key(crush_map, ruleno, dev)
            in crush_map.__dict__.get("_vc_cache", {})
            or (_crush_digest(crush_map), ruleno, str(dev)) in _VC_SHARED)
    if fused == "always" or (fused == "auto"
                             and (warm or lanes >= threshold)):
        try:
            vc = _vector_crush_for(crush_map, ruleno, dev)
        except ValueError:
            if fused == "always":
                raise
        else:
            rows = vc.map_pgs(xs, numrep, weights).astype(np.int64)
            return rows, True
    rows = np.full((lanes, numrep), CRUSH_ITEM_NONE, dtype=np.int64)
    for i, x in enumerate(xs):
        got = crush_do_rule(crush_map, ruleno, int(x), numrep,
                            weights)[:numrep]
        rows[i, :len(got)] = got
    return rows, False


def pool_pps(pool) -> np.ndarray:
    """pps seed per raw pg of a pool, vectorized (pg_pool_t::raw_pg_to_pps
    for ps in [0, pg_num))."""
    pgs = np.arange(pool.pg_num, dtype=np.int64)
    stable = np.where((pgs & pool.pgp_num_mask) < pool.pgp_num,
                      pgs & pool.pgp_num_mask,
                      pgs & (pool.pgp_num_mask >> 1))
    if pool.flags & 1:      # FLAG_HASHPSPOOL
        return crush_hash32_2_np(
            stable.astype(np.uint32),
            np.full(pool.pg_num, pool.pool_id,
                    dtype=np.int64).astype(np.uint32)).astype(np.int64)
    return stable + pool.pool_id
