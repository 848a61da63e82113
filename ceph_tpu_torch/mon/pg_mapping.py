"""The epoch placement table on the card: bulk CRUSH and ``PGMapping``.

Port of ``ceph_tpu/mon/pg_mapping.py``.  The reference never runs CRUSH per
client op: OSDMapMapping (src/osd/OSDMapMapping.h:175) holds the whole
pg->osd table, recomputed in bulk whenever a new map epoch lands, and every
lookup is an array read.

* ``bulk_crush`` maps a rule over numpy seeds to numpy rows (``crushtool
  --test``): one bulk launch when the lanes clear ``FUSED_MIN_LANES`` or the
  mapper is warm -- K5 for a map shape it takes, else (on the card) K6 --
  otherwise the scalar sweep (``crush/mapper.py``) on the host.
  ``bulk_crush_rows`` leaves the raw rows on the seeds' device; on the card
  it launches a kernel for every pool, however small, and never sweeps
  (``card_rows``): K5 for the shapes K5 takes, K6 (``crush/rule_lanes.py``,
  the scalar engine as a kernel) for every other shape.
* ``PGMapping.build`` takes each pool's seeds (``pool_seeds``: ``pool_pps``'
  hash as torch ops on the device, kept per pool spec) and maps them, then
  applies the OSDMap's semantics to the rows where they lie, as torch ops:
  upmap on the rows that carry items, the live filter with EC holes
  normalized to -1, pg_temp; one copy of the whole table comes back.  The
  table is arrays, not lists: per pool ``up`` and ``acting`` are int32
  ``(pg_num, width)`` padded with -1, each with its row lengths.  ``delta``
  compares two tables' arrays on the device.  With ``device="cpu"`` the
  same torch code runs on CPU tensors (the bulk mapper is K5's plain
  version, and small pools and shapes K5 does not take the scalar sweep).
"""

from __future__ import annotations

import hashlib
import json
import os
import time

import numpy as np
import torch

from ..crush.hashes import crush_hash32_2_np
from ..crush.rule_lanes import RuleLanes, plain_rows as _sweep
from ..crush.state import crush_to_dict
from ..crush.types import CRUSH_ITEM_NONE
from ..crush.vectorized import (MapsNothing, Unexpressed, VectorCrush,
                                hash32_2, seed_tensor)
from ..device import resolve_device

# below this many lanes a cold bulk mapper's set-up (tables, a kernel build
# on first use) is not worth it to ``bulk_crush``, which then sweeps on the
# host -- the small maps of unit tests.  The table on the card ignores it.
FUSED_MIN_LANES = int(os.environ.get("CEPH_TPU_PLACEMENT_FUSED_MIN",
                                     "2048"))

# structurally-identical maps share ONE mapper process-wide (bounded: stale
# structures age out): an in-process cluster runs one CrushMap object per
# daemon, all deserialized from the same mon map.
_VC_SHARED: dict[tuple, VectorCrush] = {}
_VC_SHARED_MAX = 8
# K5's refusals (``Unexpressed``, ``MapsNothing``) of a structure and rule,
# so a refused (map, rule) pays for the refusal once, not once a pool and
# an epoch; bounded the same way
_VC_REFUSED: dict[tuple, ValueError] = {}
# K6's flattened (map, rule) per device, shared the same way
_RL_SHARED: dict[tuple, RuleLanes] = {}

# each pool's seeds per device (``cached_pool_seeds``), bounded the same way
_SEEDS: dict[tuple, torch.Tensor] = {}
_SEEDS_MAX = 16


def _crush_digest(crush_map) -> str:
    """Structural fingerprint of a CrushMap (buckets/rules/tunables/
    choose_args), cached on the object (maps are replaced wholesale on
    change, never mutated in place)."""
    dig = crush_map.__dict__.get("_structure_digest")
    if dig is None:
        # choose_args and legacy straw values are baked into the mappers
        # but are NOT part of crush_to_dict -- digest them explicitly
        straws = {bid: b.straws for bid, b in crush_map.buckets.items()
                  if getattr(b, "straws", None) is not None}
        blob = json.dumps(
            {"crush": crush_to_dict(crush_map),
             "choose_args": getattr(crush_map, "choose_args", None),
             "straws": straws},
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
    ``Unexpressed``, before any launch, for a map shape K5 does not take,
    ``MapsNothing`` for a rule that maps nothing; a refusal is kept per
    structure and rule and raised again without a new mapper."""
    dev = resolve_device(device)
    cache = crush_map.__dict__.setdefault("_vc_cache", {})
    key = _cache_key(crush_map, ruleno, dev)
    if key not in cache:
        digest = _crush_digest(crush_map)
        refused = _VC_REFUSED.get((digest, ruleno))
        if refused is not None:
            raise type(refused)(*refused.args)
        shared_key = (digest, ruleno, str(dev))
        vc = _VC_SHARED.get(shared_key)
        if vc is None:
            try:
                vc = VectorCrush(crush_map, ruleno, device=dev)
            except (Unexpressed, MapsNothing) as e:
                while len(_VC_REFUSED) >= _VC_SHARED_MAX:
                    _VC_REFUSED.pop(next(iter(_VC_REFUSED)))
                _VC_REFUSED[(digest, ruleno)] = e
                raise
            while len(_VC_SHARED) >= _VC_SHARED_MAX:
                _VC_SHARED.pop(next(iter(_VC_SHARED)))
            _VC_SHARED[shared_key] = vc
        cache[key] = vc
    return cache[key]


def _rule_lanes_for(crush_map, ruleno: int, device=None) -> RuleLanes:
    """K6's flattened (map, rule) on ``device``, shared across
    structurally-identical maps process-wide (bounded as K5's mappers are).
    Raises ``ValueError`` for a malformed map, before any launch."""
    dev = resolve_device(device)
    key = (_crush_digest(crush_map), ruleno, str(dev))
    rl = _RL_SHARED.get(key)
    if rl is None:
        rl = RuleLanes(crush_map, ruleno, device=dev)
        while len(_RL_SHARED) >= _VC_SHARED_MAX:
            _RL_SHARED.pop(next(iter(_RL_SHARED)))
        _RL_SHARED[key] = rl
    return rl


def _warm(crush_map, ruleno: int, dev: torch.device) -> bool:
    """Whether the (map, rule) already has a mapper on ``dev``, K5's or
    K6's: its bulk launch is then all but free."""
    shared_key = (_crush_digest(crush_map), ruleno, str(dev))
    return (_cache_key(crush_map, ruleno, dev)
            in crush_map.__dict__.get("_vc_cache", {})
            or shared_key in _VC_SHARED or shared_key in _RL_SHARED)


def bulk_crush(crush_map, ruleno: int, xs, numrep: int, weights,
               fused: str = "auto", min_lanes: int | None = None,
               device=None) -> tuple[np.ndarray, bool]:
    """Map every seed through one rule, numpy to numpy: (rows, used_fused),
    rows (len(xs), numrep) int64 with CRUSH_ITEM_NONE holes -- the raw
    result vector, before any OSDMap-level filtering.  Seeds are taken as
    their low 32 bits (``seed_tensor``).

    ``fused``: 'auto' takes the bulk mapper when the lane count clears
    ``min_lanes`` or the (map, rule) already has a mapper: K5 on the card
    (its plain version with ``device="cpu"``) for a shape it takes, else K6
    on the card and the scalar sweep with ``device="cpu"``; below the lanes
    a cold (map, rule) takes the scalar sweep on the host.  'always' forces
    K5 (raising ``Unexpressed`` if the shape is refused); 'never' is the
    pure scalar sweep.  A rule that maps nothing gives NONE rows on any
    route.  A kernel build or launch failure is a RuntimeError and
    propagates, as does the ValueError of a malformed map.
    """
    dev = resolve_device(device)
    lanes = len(xs)
    threshold = FUSED_MIN_LANES if min_lanes is None else min_lanes
    if fused == "always" or (fused == "auto" and (
            lanes >= threshold or _warm(crush_map, ruleno, dev))):
        try:
            vc = _vector_crush_for(crush_map, ruleno, dev)
        except MapsNothing:
            return np.full((lanes, numrep), CRUSH_ITEM_NONE, np.int64), False
        except Unexpressed:
            if fused == "always":
                raise
            if dev.type == "cuda":
                rows = _rule_lanes_for(crush_map, ruleno, dev).map_device(
                    seed_tensor(xs, dev), numrep, weights)
                return rows.cpu().numpy().astype(np.int64), True
        else:
            return vc.map_pgs(xs, numrep, weights).astype(np.int64), True
    return _sweep(crush_map, ruleno, xs, numrep, weights).astype(np.int64), \
        False


def bulk_crush_rows(crush_map, ruleno: int, seeds: torch.Tensor, numrep: int,
                    weights, fused: str = "auto",
                    min_lanes: int | None = None) -> tuple[torch.Tensor, bool]:
    """``bulk_crush`` with the rows left on the seeds' device: (rows,
    used_fused), rows an (L, numrep) int32 tensor.  ``seeds`` is
    ``seed_tensor``'s (L,) int32.

    On the card a kernel launches for every pool, whatever the lane count
    (``fused`` and ``min_lanes`` do not apply), and ``fused="never"`` raises
    ValueError; ``card_rows`` is that route.  CPU seeds take
    ``bulk_crush``'s routes.
    """
    dev = seeds.device
    if dev.type == "cpu":
        rows, used = bulk_crush(crush_map, ruleno, seeds.numpy(), numrep,
                                weights, fused=fused, min_lanes=min_lanes,
                                device=dev)
        return torch.from_numpy(rows.astype(np.int32)), used
    if fused == "never":
        raise ValueError(f"the scalar sweep maps on the host, not {dev}")
    return card_rows(crush_map, ruleno, seeds, numrep, weights)


def card_rows(crush_map, ruleno: int, seeds: torch.Tensor, numrep: int,
              weights, mapper=None) -> tuple[torch.Tensor, bool]:
    """The card's route for one pool, chosen by the map's shape before any
    launch: (rows on the seeds' device, used_fused).  ``mapper(crush_map,
    ruleno, device)`` builds K5's bulk mapper (``_vector_crush_for`` unless
    given); ``_rule_lanes_for`` builds K6's.

    * A shape K5 takes: one K5 launch.
    * A rule that maps nothing: NONE rows made on the device, no launch.
    * A shape K5 does not express (``vectorized.Unexpressed``): one K6
      launch.  Nothing is mapped on the host; the scalar engine serves such
      a map only in a CPU build (``device="cpu"``).

    A K5 or K6 build or launch failure is a RuntimeError and propagates, as
    does the ValueError of a malformed map.
    """
    dev = seeds.device
    try:
        vc = (mapper or _vector_crush_for)(crush_map, ruleno, dev)
    except MapsNothing:
        return torch.full((seeds.shape[0], numrep), CRUSH_ITEM_NONE,
                          dtype=torch.int32, device=dev), False
    except Unexpressed:
        rl = _rule_lanes_for(crush_map, ruleno, dev)
        return rl.map_device(seeds, numrep, weights), True
    return vc.map_device(seeds, numrep, weights), True


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


def pool_seeds(pool, device) -> torch.Tensor:
    """``seed_tensor(pool_pps(pool), device)`` made on ``device``: the same
    stable mod and rjenkins hash as torch ops (``vectorized.hash32_2``), so
    no seed crosses to the card."""
    pgs = torch.arange(pool.pg_num, dtype=torch.int64, device=device)
    mask = pool.pgp_num_mask
    stable = torch.where((pgs & mask) < pool.pgp_num, pgs & mask,
                         pgs & (mask >> 1))
    if pool.flags & 1:      # FLAG_HASHPSPOOL
        pps = hash32_2(stable, torch.tensor(pool.pool_id, device=device))
    else:
        pps = (stable + pool.pool_id) & 0xFFFFFFFF
    return torch.where(pps >= 2**31, pps - 2**32, pps).to(torch.int32)


def cached_pool_seeds(pool, device) -> torch.Tensor:
    """``pool_seeds``, kept per (pool id, pg_num, pgp_num, flags, device):
    the seeds depend on nothing else, so an epoch that changes weights, up
    state or overrides reuses them.  Bounded: the oldest entries age out.
    The tensor is shared; callers do not write to it."""
    key = (pool.pool_id, pool.pg_num, pool.pgp_num, pool.flags, str(device))
    seeds = _SEEDS.get(key)
    if seeds is None:
        seeds = pool_seeds(pool, device)
        while len(_SEEDS) >= _SEEDS_MAX:
            _SEEDS.pop(next(iter(_SEEDS)))
        _SEEDS[key] = seeds
    return seeds


def live_osds(osdmap, n: int) -> np.ndarray:
    """live[o] <=> the post-CRUSH filter keeps osd o (exists and up), for o
    in [0, n)."""
    live = np.zeros(n, dtype=bool)
    for o, info in osdmap.osds.items():
        if info.up and o < n:
            live[o] = True
    return live


def _pool_pgs(overrides: dict, pool_id: int, pg_num: int) -> list:
    """(pgid, pg) for the keys of ``overrides`` (pg_temp, pg_upmap_items)
    that name a pg of this pool, in the dict's order.  Keys of another pool
    ("11.0" is not pool 1's), keys that do not parse and pgs past pg_num are
    skipped, as the reference skips them."""
    prefix = f"{pool_id}."
    out = []
    for pgid in overrides:
        if not pgid.startswith(prefix):
            continue
        try:
            pg = int(pgid.split(".", 1)[1], 16)
        except ValueError:
            continue
        if 0 <= pg < pg_num:
            out.append((pgid, pg))
    return out


class PGMapping:
    """The full-cluster placement table for one OSDMap epoch.

    ``up`` and ``acting`` per (pool, raw pg), entry-identical to the per-PG
    ``OSDMap._pg_to_up_acting_scalar`` result.  Per pool the table holds
    four int32 arrays: ``up`` and ``acting`` of shape (pg_num, width),
    padded with -1 past each row's length, and the lengths.  ``up``'s width
    is the pool's size; ``acting``'s the larger of that and the longest
    pg_temp the pool applies.  They are kept twice: on the build's device
    (``delta`` reads them there) and on the host (``lookup``, ``tables``).
    Instances are immutable snapshots: a new epoch builds a new PGMapping
    (OSDMap memoizes one per mutation generation and hands the previous one
    to ``delta``)."""

    def __init__(self, epoch: int, device) -> None:
        self.epoch = epoch
        self.device = torch.device(device)
        self.fused_pools = 0
        self.scalar_pools = 0
        # pool_id -> (up, up_len, acting, acting_len)
        self._dev: dict[int, tuple[torch.Tensor, ...]] = {}
        self._host: dict[int, tuple[np.ndarray, ...]] = {}
        self._pg_num: dict[int, int] = {}
        self._pg_num_mask: dict[int, int] = {}

    # -- construction -------------------------------------------------------
    @classmethod
    def build(cls, osdmap, perf=None, fused: str = "auto",
              min_lanes: int | None = None) -> "PGMapping":
        """The table of ``osdmap``'s epoch, built on ``osdmap.device`` (a
        RuntimeError when that is CUDA and there is no card).  ``fused`` and
        ``min_lanes`` pick a CPU build's route (``bulk_crush``); on the card
        every pool takes a kernel, K5 or, for a map shape K5 does not
        express, K6 (``card_rows``).  ``scalar_pools`` counts the pools no
        kernel or bulk mapper mapped: swept on the host, or a rule that maps
        nothing."""
        t0 = time.perf_counter()
        dev = resolve_device(osdmap.device)
        pm = cls(osdmap.epoch, dev)
        weights = osdmap.osd_weights()
        live = live_osds(osdmap, len(weights) + 1)
        for pool_id, pool in osdmap.pools.items():
            rows, used_fused = bulk_crush_rows(
                osdmap.crush, pool.crush_rule, cached_pool_seeds(pool, dev),
                pool.size, weights, fused=fused, min_lanes=min_lanes)
            if used_fused:
                pm.fused_pools += 1
            else:
                pm.scalar_pools += 1
            pm._ingest_pool(osdmap, pool_id, pool, rows, live)
        pm._copy_back()
        dt = time.perf_counter() - t0
        if perf is not None:
            perf.inc("bulk_recomputes")
            perf.inc("fused_pools", pm.fused_pools)
            perf.inc("scalar_pools", pm.scalar_pools)
            perf.tinc("recompute", dt)
            total = sum(pm._pg_num.values())
            if dt > 0:
                perf.set_gauge("recompute_pgs_per_s",
                               round(total / dt, 1))
        return pm

    def _ingest_pool(self, osdmap, pool_id: int, pool, rows: torch.Tensor,
                     live: np.ndarray) -> None:
        """Raw CRUSH rows (int32, on this table's device; rewritten in
        place) -> up/acting with the full OSDMap semantics (OSDMap.cc
        _apply_upmap, _raw_to_up_osds, pg_temp): torch ops over the dense
        rows, Python only for the sparse override dicts."""
        dev = self.device
        n_live = live.shape[0]
        npg, size = rows.shape
        # upmap rewrite first (it edits the RAW result, NONE entries
        # included): only the pgs that carry items, in the dict's order
        items = _pool_pgs(osdmap.pg_upmap_items, pool_id, pool.pg_num)
        if items:
            pgs = sorted({pg for _, pg in items})
            idx = torch.tensor(pgs, dtype=torch.long, device=dev)
            raw = dict(zip(pgs, rows[idx].tolist()))
            for pgid, pg in items:
                raw[pg] = osdmap._apply_upmap(pgid, raw[pg])
            rows[idx] = torch.tensor([raw[pg] for pg in pgs],
                                     dtype=torch.int32, device=dev)
        # live filter, holes normalized to -1 (EC shard ids ride the
        # position, so indep pools keep holes; replicated compact in order)
        live_d = torch.from_numpy(live).to(dev)
        ok = ((rows != CRUSH_ITEM_NONE) & (rows >= 0) & (rows < n_live)
              & live_d[rows.clamp(0, n_live - 1).long()])
        up = torch.where(ok, rows, -1)
        if pool.can_shift_osds():
            order = torch.sort((~ok).to(torch.int8), dim=1,
                               stable=True).indices
            up = up.gather(1, order)
            up_len = ok.sum(dim=1, dtype=torch.int32)
        else:
            up_len = torch.full((npg,), size, dtype=torch.int32, device=dev)
        # pg_temp overrides the acting set; a temp whose filtered list is
        # empty falls back to up (an EC temp of holes is not empty)
        temps: dict[int, list[int]] = {}
        for pgid, pg in _pool_pgs(osdmap.pg_temp, pool_id, pool.pg_num):
            temp = osdmap.pg_temp[pgid]
            if not temp:
                continue
            act = [int(o) if (o != CRUSH_ITEM_NONE and o >= 0
                              and o < n_live and live[o]) else -1
                   for o in temp]
            if pool.can_shift_osds():
                act = [o for o in act if o >= 0]
            if act:
                temps[pg] = act
            else:
                temps.pop(pg, None)
        width = max([size] + [len(a) for a in temps.values()])
        acting = torch.nn.functional.pad(up, (0, width - size), value=-1)
        acting_len = up_len.clone()
        if temps:
            pgs = sorted(temps)
            block = np.full((len(pgs), width), -1, dtype=np.int32)
            for i, pg in enumerate(pgs):
                block[i, :len(temps[pg])] = temps[pg]
            idx = torch.tensor(pgs, dtype=torch.long, device=dev)
            acting[idx] = torch.from_numpy(block).to(dev)
            acting_len[idx] = torch.tensor([len(temps[pg]) for pg in pgs],
                                           dtype=torch.int32, device=dev)
        self._dev[pool_id] = (up, up_len, acting, acting_len)
        self._pg_num[pool_id] = pool.pg_num
        self._pg_num_mask[pool_id] = pool.pg_num_mask

    def _copy_back(self) -> None:
        """Every pool's arrays packed into one buffer on the device, copied
        to the host in one transfer; both sides become views of it."""
        parts = [t for arrays in self._dev.values() for t in arrays]
        if not parts:
            return
        flat = torch.cat([t.reshape(-1) for t in parts])
        host = flat.cpu().numpy()
        off = 0
        for pool_id, arrays in self._dev.items():
            dev_views, host_views = [], []
            for t in arrays:
                n = t.numel()
                dev_views.append(flat[off:off + n].view(t.shape))
                host_views.append(host[off:off + n].reshape(t.shape))
                off += n
            self._dev[pool_id] = tuple(dev_views)
            self._host[pool_id] = tuple(host_views)

    # -- queries ------------------------------------------------------------
    def raw_pg(self, pool_id: int, ps: int) -> int:
        b, mask = self._pg_num[pool_id], self._pg_num_mask[pool_id]
        return ps & mask if (ps & mask) < b else ps & (mask >> 1)

    def lookup(self, pool_id: int,
               ps: int) -> tuple[list[int], list[int]]:
        """(up, acting) for a pg: one table read.  Returns fresh lists
        (callers historically mutate/keep the per-call result)."""
        pg = self.raw_pg(pool_id, ps)
        up, up_len, acting, acting_len = self._host[pool_id]
        return up[pg, :up_len[pg]].tolist(), \
            acting[pg, :acting_len[pg]].tolist()

    def tables(self) -> dict[int, tuple[np.ndarray, ...]]:
        """pool_id -> (up, up_len, acting, acting_len): the host arrays,
        read-only."""
        return self._host

    def iter_all(self):
        """Yield (pool_id, pg, up, acting) over the whole table."""
        for pool_id, (up, up_len, acting, acting_len) in self._host.items():
            for pg, (u, nu, a, na) in enumerate(zip(
                    up.tolist(), up_len.tolist(), acting.tolist(),
                    acting_len.tolist())):
                yield pool_id, pg, u[:nu], a[:na]

    def pg_count(self) -> int:
        return sum(self._pg_num.values())

    # -- deltas -------------------------------------------------------------
    def delta(self, prev: "PGMapping",
              perf=None) -> list[tuple[int, int]]:
        """(pool_id, pg) for every entry whose up OR acting differs
        from ``prev``, including pgs of pools present in only one of
        the two tables (pool create/delete, pg_num resize).  Exactly
        the brute-force entry-for-entry diff, so a map consumer can
        retarget only what moved; the arrays are compared on the device."""
        if prev is self:
            # placement-neutral epochs (up_thru/blocklist-only) carry
            # the table object across generations: nothing moved
            return []
        changed: list[tuple[int, int]] = []
        for pool_id in sorted(set(self._dev) | set(prev._dev)):
            cur, old = self._dev.get(pool_id), prev._dev.get(pool_id)
            if cur is None or old is None:
                npg = (cur if cur is not None else old)[0].shape[0]
                changed.extend((pool_id, pg) for pg in range(npg))
                continue
            n_cur, n_old = cur[0].shape[0], old[0].shape[0]
            n = min(n_cur, n_old)
            moved = torch.zeros(n, dtype=torch.bool, device=self.device)
            for i in (0, 2):            # up, then acting: rows and lengths
                a, b = cur[i][:n], old[i][:n]
                width = max(a.shape[1], b.shape[1])
                a = torch.nn.functional.pad(a, (0, width - a.shape[1]),
                                            value=-1)
                b = torch.nn.functional.pad(b, (0, width - b.shape[1]),
                                            value=-1)
                moved |= (a != b).any(dim=1)
                moved |= cur[i + 1][:n] != old[i + 1][:n]
            changed.extend((pool_id, pg) for pg in
                           torch.nonzero(moved).flatten().tolist())
            changed.extend((pool_id, pg) for pg in range(n, max(n_cur, n_old)))
        if perf is not None:
            perf.inc("delta_pgs", len(changed))
        return changed
