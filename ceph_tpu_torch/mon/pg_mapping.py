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
  normalized to -1, pg_temp.  What the host knows before the launch (the
  live OSDs, the upmap items, the pg_temps: ``BuildInputs``) goes up in one
  copy, and the whole table comes back in one: a build waits for the card
  once.  The table is arrays, not lists: per pool ``up`` and ``acting`` are
  int32 ``(pg_num, width)`` padded with -1, each with its row lengths, on
  the host.  ``delta`` compares two tables' host arrays.  With
  ``device="cpu"`` the same torch code runs on CPU tensors (the bulk mapper
  is K5's plain version, and small pools and shapes K5 does not take the
  scalar sweep).
* ``shared_table`` hands the maps of one process that hold the same
  placement inputs (``table_key``) one immutable table: an in-process
  cluster's daemons and clients each hold their own copy of every epoch.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
import weakref

import numpy as np
import torch

from ..crush.hashes import crush_hash32_2_np
from ..crush.rule_lanes import RuleLanes, plain_rows as _sweep
from ..crush.state import crush_to_dict
from ..crush.types import CRUSH_ITEM_NONE
from ..crush.vectorized import (MapsNothing, Unexpressed, VectorCrush,
                                hash32_2, seed_tensor)
from .. import device as device_mod
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

# the tables ``shared_table`` built, by ``table_key``; the oldest go.  An
# in-process cluster's holders work through a burst of epochs at their own
# pace (64 OSDs booting make 64 epochs), so the bound covers such a burst
_TABLES: dict[tuple, "PGMapping"] = {}
_TABLES_MAX = 64

# a build's copies between the host and its device, counted where they are
# made (``_upload``, ``_download``): one each a build
TRANSFERS = {"to_device": 0, "to_host": 0}
# the tables ``PGMapping.build`` made in this process
BUILDS = {"tables": 0}


def _upload(arr: np.ndarray, dev: torch.device) -> torch.Tensor:
    """``arr`` on ``dev``; to the card from pinned memory, without waiting
    for it."""
    TRANSFERS["to_device"] += 1
    t = torch.from_numpy(arr)
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


def _download(t: torch.Tensor) -> np.ndarray:
    """``t`` on the host: the one wait for the card of a build."""
    TRANSFERS["to_host"] += 1
    return t.cpu().numpy()


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
                # lint: disable=device-path-host-sync -- numpy API: one post-launch hop
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
        pps = hash32_2(stable, torch.full_like(stable, pool.pool_id))
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


def _by_pg(overrides: dict, value=tuple) -> tuple:
    """A pg_temp or upmap dict as the build reads it, whatever its order:
    each key's ``value(v)`` under the pg it names (``(pool, pg)``, or the key
    itself when it does not parse), sorted by pg, in the dict's order within
    a pg (two keys naming one pg apply in that order)."""
    out: dict = {}
    for key, v in overrides.items():
        pool, _, ps = key.partition(".")
        try:
            pg = (pool, int(ps, 16))
        except ValueError:
            pg = (key, -1)
        out.setdefault(pg, []).append(value(v))
    return tuple(sorted((pg, tuple(vs)) for pg, vs in out.items()))


def _pairs(items) -> tuple:
    return tuple(map(tuple, items))


def table_key(osdmap) -> tuple:
    """Every input of ``PGMapping.build(osdmap)``, in a canonical order:
    the device, the CRUSH map's structure, the weights, which OSDs exist
    and are up, the pools' placement fields, the pg_temps and upmap items.
    Maps with equal keys get entry-identical tables, whatever their epochs
    and however their dicts were filled."""
    return (_device_name(osdmap.device), _crush_digest(osdmap.crush),
            tuple(osdmap.osd_weights()),
            tuple(sorted((o, info.up) for o, info in osdmap.osds.items())),
            tuple(sorted((pid, p.pool_id, p.pg_num, p.pgp_num, p.flags,
                          p.size, p.crush_rule, p.can_shift_osds())
                         for pid, p in osdmap.pools.items())),
            _by_pg(osdmap.pg_temp), _by_pg(osdmap.pg_upmap_items, _pairs))


_DEVICES: dict = {}


def _device_name(device) -> str:
    """``str(resolve_device(device))``, resolved once for each name and
    default."""
    key = (str(device), device_mod.DEFAULT_DEVICE)
    name = _DEVICES.get(key)
    if name is None:
        name = _DEVICES[key] = str(resolve_device(device))
    return name


def shared_table(osdmap, perf=None) -> "PGMapping":
    """``PGMapping.build(osdmap)``, built once for all the maps of this
    process with the same ``table_key`` (the newest ``_TABLES_MAX`` keys are
    kept).  ``perf`` counts a build as ``bulk_recomputes`` and a table found
    built as ``shared_tables``."""
    key = table_key(osdmap)
    pm = _TABLES.get(key)
    if pm is not None:
        if perf is not None:
            perf.inc("shared_tables")
        return pm
    pm = PGMapping.build(osdmap, perf=perf)
    while len(_TABLES) >= _TABLES_MAX:
        _TABLES.pop(next(iter(_TABLES)))
    _TABLES[key] = pm
    return pm


class BuildInputs:
    """What a build applies that the host knows before any launch: the live
    OSDs, each pool's upmap items and pg_temps, packed into one int32 buffer
    and copied to the device once.

    * ``live`` (host bool array, index < ``n_live``) and ``live_dev``;
    * ``upmaps[pool_id]``: (pgs, frm, to, ok) on the device, ``pgs`` the
      distinct pgs with items, the others (steps, len(pgs)): each pg's j-th
      item at step j, ``ok`` false for padding and for an item whose target
      does not exist (``OSDMap._apply_upmap`` skips those);
    * ``temps[pool_id]``: (width, pgs, block, lens), the pg_temps after the
      live filter, ``block`` (len(pgs), width) padded with -1."""

    def __init__(self, osdmap, n_live: int, dev: torch.device) -> None:
        self.n_live = n_live
        self.live = live_osds(osdmap, n_live)
        parts: list[np.ndarray] = [self.live.astype(np.int32)]
        upmaps, temps = {}, {}
        for pool_id, pool in osdmap.pools.items():
            plan = self._upmap_plan(osdmap, pool_id, pool)
            if plan is not None:
                upmaps[pool_id] = len(parts)
                parts.extend(plan)
            width, plan = self._temp_plan(osdmap, pool_id, pool)
            temps[pool_id] = (width, len(parts) if plan else None)
            parts.extend(plan)
        sizes = [p.size for p in parts]
        flat = np.concatenate([p.reshape(-1) for p in parts])
        dev_flat = _upload(flat, dev)
        views, off = [], 0
        for p, n in zip(parts, sizes):
            views.append(dev_flat[off:off + n].view(p.shape))
            off += n
        self.live_dev = views[0] != 0
        self.upmaps = {pid: (views[i].long(), views[i + 1], views[i + 2],
                             views[i + 3] != 0)
                       for pid, i in upmaps.items()}
        self.temps = {pid: (width, None if i is None else
                            (views[i].long(), views[i + 1], views[i + 2]))
                      for pid, (width, i) in temps.items()}

    @staticmethod
    def _upmap_plan(osdmap, pool_id: int, pool) -> list | None:
        """[pgs, frm, to, ok] for a pool's upmap items, or None."""
        seq: dict[int, list[tuple[int, int, bool]]] = {}
        for pgid, pg in _pool_pgs(osdmap.pg_upmap_items, pool_id,
                                  pool.pg_num):
            for frm, to in osdmap.pg_upmap_items[pgid]:
                # an id past int32 matches no row entry and is never placed
                fits = all(-2**31 <= v < 2**31 for v in (frm, to))
                seq.setdefault(pg, []).append(
                    (frm if fits else 0, to if fits else 0,
                     fits and osdmap.exists(to)))
        if not seq:
            return None
        pgs = sorted(seq)
        steps = max(len(v) for v in seq.values())
        frm = np.zeros((steps, len(pgs)), np.int32)
        to = np.zeros_like(frm)
        ok = np.zeros_like(frm)
        for i, pg in enumerate(pgs):
            for j, (f, t, good) in enumerate(seq[pg]):
                frm[j, i], to[j, i], ok[j, i] = f, t, good
        return [np.asarray(pgs, np.int32), frm, to, ok]

    def _temp_plan(self, osdmap, pool_id: int, pool) -> tuple[int, list]:
        """(acting width, [pgs, block, lens] or []) for a pool's pg_temps:
        a temp whose filtered list is empty falls back to up (an EC temp of
        holes is not empty)."""
        live, n_live = self.live, self.n_live
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
        width = max([pool.size] + [len(a) for a in temps.values()])
        if not temps:
            return width, []
        pgs = sorted(temps)
        block = np.full((len(pgs), width), -1, dtype=np.int32)
        for i, pg in enumerate(pgs):
            block[i, :len(temps[pg])] = temps[pg]
        lens = np.asarray([len(temps[pg]) for pg in pgs], np.int32)
        return width, [np.asarray(pgs, np.int32), block, lens]


class PGMapping:
    """The full-cluster placement table for one OSDMap epoch.

    ``up`` and ``acting`` per (pool, raw pg), entry-identical to the per-PG
    ``OSDMap._pg_to_up_acting_scalar`` result.  Per pool the table holds
    four int32 host arrays: ``up`` and ``acting`` of shape (pg_num, width),
    padded with -1 past each row's length, and the lengths.  ``up``'s width
    is the pool's size; ``acting``'s the larger of that and the longest
    pg_temp the pool applies.  They are made on the build's device and
    copied back in one transfer.  Instances are immutable snapshots: a new
    epoch builds a new PGMapping (OSDMap memoizes one per mutation
    generation and hands the previous one to ``delta``); ``epoch`` is the
    epoch of the map it was built for, and a shared table (``shared_table``)
    serves every map with the same inputs."""

    def __init__(self, epoch: int, device) -> None:
        self.epoch = epoch
        self.device = torch.device(device)
        self.fused_pools = 0
        self.scalar_pools = 0
        # pool_id -> (up, up_len, acting, acting_len): on the device until
        # ``_copy_back``, then on the host
        self._pending: dict[int, tuple[torch.Tensor, ...]] = {}
        self._host: dict[int, tuple[np.ndarray, ...]] = {}
        self._pg_num: dict[int, int] = {}
        self._pg_num_mask: dict[int, int] = {}
        # the last ``delta``: (weak reference to prev, its result)
        self._delta_memo: tuple | None = None

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
        inputs = BuildInputs(osdmap, len(weights) + 1, dev)
        for pool_id, pool in osdmap.pools.items():
            rows, used_fused = bulk_crush_rows(
                osdmap.crush, pool.crush_rule, cached_pool_seeds(pool, dev),
                pool.size, weights, fused=fused, min_lanes=min_lanes)
            if used_fused:
                pm.fused_pools += 1
            else:
                pm.scalar_pools += 1
            pm._ingest_pool(pool_id, pool, rows, inputs)
        pm._copy_back()
        BUILDS["tables"] += 1
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

    def _ingest_pool(self, pool_id: int, pool, rows: torch.Tensor,
                     inputs: BuildInputs) -> None:
        """Raw CRUSH rows (int32, on this table's device; rewritten in
        place) -> up/acting with the full OSDMap semantics (OSDMap.cc
        _apply_upmap, _raw_to_up_osds, pg_temp), as torch ops over the rows
        and ``inputs``' tensors: nothing is read back."""
        dev = self.device
        n_live = inputs.n_live
        npg, size = rows.shape
        # upmap rewrite first (it edits the RAW result, NONE entries
        # included): the rows that carry items, each pg's items in order --
        # an item is skipped when its target is already in the row, else it
        # replaces the first entry equal to its source
        plan = inputs.upmaps.get(pool_id)
        if plan is not None:
            idx, frm, to, ok = plan
            sub = rows[idx]
            for j in range(frm.shape[0]):
                f, t = frm[j][:, None], to[j][:, None]
                hit = sub == f
                first = hit & (hit.cumsum(dim=1) == 1)
                apply = ok[j] & ~(sub == t).any(dim=1)
                sub = torch.where(first & apply[:, None], t, sub)
            rows[idx] = sub
        # live filter, holes normalized to -1 (EC shard ids ride the
        # position, so indep pools keep holes; replicated compact in order)
        ok = ((rows != CRUSH_ITEM_NONE) & (rows >= 0) & (rows < n_live)
              & inputs.live_dev[rows.clamp(0, n_live - 1).long()])
        up = torch.where(ok, rows, -1)
        if pool.can_shift_osds():
            order = torch.sort((~ok).to(torch.int8), dim=1,
                               stable=True).indices
            up = up.gather(1, order)
            up_len = ok.sum(dim=1, dtype=torch.int32)
        else:
            up_len = torch.full((npg,), size, dtype=torch.int32, device=dev)
        # pg_temp overrides the acting set
        width, temps = inputs.temps[pool_id]
        acting = torch.nn.functional.pad(up, (0, width - size), value=-1)
        acting_len = up_len.clone()
        if temps is not None:
            idx, block, lens = temps
            acting[idx] = block
            acting_len[idx] = lens
        self._pending[pool_id] = (up, up_len, acting, acting_len)
        self._pg_num[pool_id] = pool.pg_num
        self._pg_num_mask[pool_id] = pool.pg_num_mask

    def _copy_back(self) -> None:
        """Every pool's arrays packed into one buffer on the device and
        copied to the host in one transfer; the host arrays are views of
        it."""
        parts = [t for arrays in self._pending.values() for t in arrays]
        if not parts:
            return
        host = _download(torch.cat([t.reshape(-1) for t in parts]))
        off = 0
        for pool_id, arrays in self._pending.items():
            views = []
            for t in arrays:
                n = t.numel()
                views.append(host[off:off + n].reshape(t.shape))
                off += n
            self._host[pool_id] = tuple(views)
        self._pending = {}

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
        retarget only what moved.  The last result is kept: the holders
        of a shared table ask for the same delta."""
        if prev is self:
            # placement-neutral epochs (up_thru/blocklist-only) carry
            # the table object across generations: nothing moved
            return []
        memo = self._delta_memo
        if memo is not None and memo[0]() is prev:
            changed = list(memo[1])
        else:
            changed = self._diff(prev)
            self._delta_memo = (weakref.ref(prev), tuple(changed))
        if perf is not None:
            perf.inc("delta_pgs", len(changed))
        return changed

    def _diff(self, prev: "PGMapping") -> list[tuple[int, int]]:
        changed: list[tuple[int, int]] = []
        for pool_id in sorted(set(self._host) | set(prev._host)):
            cur, old = self._host.get(pool_id), prev._host.get(pool_id)
            if cur is None or old is None:
                npg = (cur if cur is not None else old)[0].shape[0]
                changed.extend((pool_id, pg) for pg in range(npg))
                continue
            n_cur, n_old = cur[0].shape[0], old[0].shape[0]
            n = min(n_cur, n_old)
            moved = np.zeros(n, dtype=bool)
            for i in (0, 2):            # up, then acting: rows and lengths
                a, b = cur[i][:n], old[i][:n]
                width = max(a.shape[1], b.shape[1])
                a = np.pad(a, ((0, 0), (0, width - a.shape[1])),
                           constant_values=-1)
                b = np.pad(b, ((0, 0), (0, width - b.shape[1])),
                           constant_values=-1)
                moved |= (a != b).any(axis=1)
                moved |= cur[i + 1][:n] != old[i + 1][:n]
            changed.extend((pool_id, pg)
                           for pg in np.flatnonzero(moved).tolist())
            changed.extend((pool_id, pg) for pg in range(n, max(n_cur, n_old)))
        return changed
