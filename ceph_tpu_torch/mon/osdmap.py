"""OSDMap: the cluster map clients and OSDs both compute placement from.

Semantics mirrored from src/osd/OSDMap.cc: object->pg via the rjenkins
string hash and ceph_stable_mod (:2606-2624, src/include/rados.h:96),
pg->osds via pps = crush_hash32_2(stable_mod(ps, pgp_num, mask), pool)
(src/osd/osd_types.cc:1817) into crush_do_rule, nonexistent-osd filtering
(:2651), primary = first mapped shard.  Maps evolve by Incrementals keyed
by epoch, exactly how the reference distributes MOSDMap deltas.

Port of ``ceph_tpu/mon/osdmap.py``, host code copied.  The differences: an
``OSDMap`` carries the device its placement table is built on (CUDA unless
``device="cpu"``), resolved only when the table is built
(``placement_cache``), so loading, serializing and ``apply_incremental``
need no card; and the CRUSH map's dict form is ``crush/state.py``'s.
``to_dict()`` / ``from_dict(d, device=...)`` carry a map across from
another implementation: the placement engine's state is the map itself.
A map made with ``shared_tables=True`` (the daemons' and the clients')
takes its table from ``pg_mapping.shared_table``, one for each placement
content in a process; and any blocklist entry in the map fences, whatever
its expiry (the monitor's tick removes expired entries).
"""

from __future__ import annotations

from dataclasses import dataclass, field, asdict
from typing import Any

from ..crush import (
    CrushMap, crush_do_rule, ceph_str_hash_rjenkins, crush_hash32_2,
)
from ..crush.state import crush_map_from_dict, crush_to_dict
from ..crush.types import CRUSH_ITEM_NONE

POOL_TYPE_REPLICATED = 1
POOL_TYPE_ERASURE = 3


def calc_bits_of(n: int) -> int:
    return n.bit_length()


def ceph_stable_mod(x: int, b: int, bmask: int) -> int:
    return x & bmask if (x & bmask) < b else x & (bmask >> 1)


@dataclass
class PoolSpec:
    pool_id: int
    name: str
    type: int = POOL_TYPE_REPLICATED
    size: int = 3
    min_size: int = 2
    pg_num: int = 32
    pgp_num: int = 32
    crush_rule: int = 0
    erasure_code_profile: str = ""
    flags: int = 1  # FLAG_HASHPSPOOL
    # self-managed snapshots (pg_pool_t::snap_seq / removed_snaps):
    # snap ids are allocated monotonically by the mon; removal marks
    # the id for OSD-side trimming
    snap_seq: int = 0
    removed_snaps: list = field(default_factory=list)

    @property
    def pg_num_mask(self) -> int:
        return (1 << calc_bits_of(self.pg_num - 1)) - 1

    @property
    def pgp_num_mask(self) -> int:
        return (1 << calc_bits_of(self.pgp_num - 1)) - 1

    def hash_key(self, key: str, nspace: str = "") -> int:
        if nspace:
            data = nspace.encode() + b"\x1f" + key.encode()
        else:
            data = key.encode()
        return ceph_str_hash_rjenkins(data)

    def raw_pg_to_pps(self, ps: int) -> int:
        if self.flags & 1:
            return crush_hash32_2(
                ceph_stable_mod(ps, self.pgp_num, self.pgp_num_mask),
                self.pool_id)
        return ceph_stable_mod(ps, self.pgp_num, self.pgp_num_mask) + \
            self.pool_id

    def raw_pg_to_pg(self, ps: int) -> int:
        return ceph_stable_mod(ps, self.pg_num, self.pg_num_mask)

    def is_erasure(self) -> bool:
        return self.type == POOL_TYPE_ERASURE

    def can_shift_osds(self) -> bool:
        return not self.is_erasure()


@dataclass
class OsdInfo:
    up: bool = False
    in_cluster: bool = True
    weight: int = 0x10000          # reweight, 16.16
    addr: tuple[str, int] | None = None
    uuid: str = ""
    host: str = ""
    down_at_epoch: int = 0
    # last epoch through which this OSD is known to have SERVED writes
    # as a primary (osd_info_t::up_thru): peering bumps it before
    # activating, so past intervals whose primary never got an up_thru
    # bump provably never went read-write and need not be probed
    up_thru: int = 0


@dataclass
class Incremental:
    epoch: int
    new_up: dict[int, list] = field(default_factory=dict)     # osd -> addr
    new_down: list[int] = field(default_factory=list)
    new_in: list[int] = field(default_factory=list)
    new_out: list[int] = field(default_factory=list)
    new_weights: dict[int, int] = field(default_factory=dict)
    new_pools: dict[int, dict] = field(default_factory=dict)
    removed_pools: list[int] = field(default_factory=list)
    new_crush: dict | None = None
    new_ec_profiles: dict[str, dict] = field(default_factory=dict)
    removed_ec_profiles: list[str] = field(default_factory=list)
    new_max_osd: int | None = None
    # pgid -> acting override; [] removes (OSDMap::Incremental
    # new_pg_temp semantics).  pg_upmap_items: pgid -> [[from, to]...]
    new_pg_temp: dict[str, list[int]] = field(default_factory=dict)
    new_up_thru: dict[int, int] = field(default_factory=dict)
    new_pg_upmap_items: dict[str, list] = field(default_factory=dict)
    removed_pg_upmap_items: list[str] = field(default_factory=list)
    # replicated identity/topology state: a NEW leader must be able to
    # rebuild the crush hierarchy and keep osd ids stable from the MAP
    # alone, not from the old leader's in-memory registries
    new_uuids: dict[int, str] = field(default_factory=dict)
    new_hosts: dict[int, str] = field(default_factory=dict)
    # pool_id -> {"snap_seq": int, "removed": [snapids]}
    new_pool_snaps: dict[int, dict] = field(default_factory=dict)
    # client-instance blocklist (OSDMap::Incremental new_blocklist,
    # mon/OSDMonitor.cc "osd blocklist"): instance id "name:inc" ->
    # absolute wall-clock expiry; OSDs refuse ops from listed
    # instances, fencing lease-lapsed CephFS clients and deposed rbd
    # lock holders whose delayed writes are still in flight
    new_blocklist: dict[str, float] = field(default_factory=dict)
    old_blocklist: list[str] = field(default_factory=list)

    def placement_neutral(self) -> bool:
        """True when applying this incremental cannot change any PG's
        up/acting: only liveness bookkeeping (up_thru), client fencing
        (blocklist), identity/topology labels (uuid/host), snap
        bookkeeping, EC profile registration or service payloads.
        The placement cache survives such epochs untouched — on a
        large cluster the peering storm after a pool create emits one
        up_thru epoch per PG, and rebuilding a 64-OSD full-cluster
        table on every daemon for each of them is minutes of CPU that
        produce byte-identical tables."""
        return not (self.new_up or self.new_down or self.new_in
                    or self.new_out or self.new_weights
                    or self.new_pools or self.removed_pools
                    or self.new_crush is not None
                    or self.new_max_osd is not None
                    or self.new_pg_temp or self.new_pg_upmap_items
                    or self.removed_pg_upmap_items)

    # other PaxosService payloads riding the SAME paxos commit (the
    # reference multiplexes every service over one paxos instance):
    # service -> {key: value-or-None(delete)}; applied by the Monitor's
    # service layer, opaque to the osdmap itself
    service_kv: dict[str, dict] = field(default_factory=dict)

    def to_dict(self) -> dict:
        d = asdict(self)
        d["new_up"] = {str(k): v for k, v in self.new_up.items()}
        d["new_weights"] = {str(k): v for k, v in self.new_weights.items()}
        d["new_pools"] = {str(k): v for k, v in self.new_pools.items()}
        d["new_uuids"] = {str(k): v for k, v in self.new_uuids.items()}
        d["new_hosts"] = {str(k): v for k, v in self.new_hosts.items()}
        d["new_pool_snaps"] = {str(k): v
                               for k, v in self.new_pool_snaps.items()}
        d["new_up_thru"] = {str(k): v for k, v in self.new_up_thru.items()}
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Incremental":
        return cls(
            epoch=d["epoch"],
            new_up={int(k): v for k, v in d.get("new_up", {}).items()},
            new_down=list(d.get("new_down", [])),
            new_in=list(d.get("new_in", [])),
            new_out=list(d.get("new_out", [])),
            new_weights={int(k): v
                         for k, v in d.get("new_weights", {}).items()},
            new_pools={int(k): v for k, v in d.get("new_pools", {}).items()},
            removed_pools=list(d.get("removed_pools", [])),
            new_crush=d.get("new_crush"),
            new_ec_profiles=dict(d.get("new_ec_profiles", {})),
            removed_ec_profiles=list(d.get("removed_ec_profiles", [])),
            new_max_osd=d.get("new_max_osd"),
            new_pg_temp=dict(d.get("new_pg_temp", {})),
            new_up_thru={int(k): v
                         for k, v in d.get("new_up_thru", {}).items()},
            new_pg_upmap_items=dict(d.get("new_pg_upmap_items", {})),
            removed_pg_upmap_items=list(
                d.get("removed_pg_upmap_items", [])),
            new_uuids={int(k): v
                       for k, v in d.get("new_uuids", {}).items()},
            new_hosts={int(k): v
                       for k, v in d.get("new_hosts", {}).items()},
            service_kv=dict(d.get("service_kv", {})),
            new_pool_snaps={int(k): v for k, v in
                            d.get("new_pool_snaps", {}).items()},
            new_blocklist=dict(d.get("new_blocklist", {})),
            old_blocklist=list(d.get("old_blocklist", [])),
        )


class OSDMap:
    def __init__(self, device=None, shared_tables: bool = False) -> None:
        # where the placement table is built: CUDA unless "cpu"; resolved
        # (and refused without a card) only when a table is built
        self.device = device
        self.epoch = 0
        self.max_osd = 0
        self.osds: dict[int, OsdInfo] = {}
        self.pools: dict[int, PoolSpec] = {}
        self.pool_names: dict[str, int] = {}
        self.crush = CrushMap()
        self.ec_profiles: dict[str, dict] = {}
        # placement cache plumbing (mon/pg_mapping.py): every mutation
        # entry point bumps _mutation_gen, and the memoized full-
        # cluster table + weight vector are keyed on it -- a stale-
        # generation read is structurally impossible
        self._mutation_gen = 0
        self._pcache: tuple[int, Any] | None = None
        self._weights_memo: tuple[int, list[int]] | None = None
        self._placement_perf = None
        # take the table from the process-wide registry
        # (``pg_mapping.shared_table``): set by the daemons and clients,
        # each of which holds its own copy of the same epoch
        self.shared_tables = shared_tables
        # explicit placement overrides (OSDMap.cc:2705 _apply_upmap /
        # pg_temp): upmap items rewrite the raw CRUSH result (balancer
        # output), pg_temp overrides the ACTING set only (serving
        # continuity while the up set backfills)
        self.pg_temp: dict[str, list[int]] = {}
        self.pg_upmap_items: dict[str, list[tuple[int, int]]] = {}
        # fenced client instances: "name:incarnation" -> expiry (the
        # monitor's wall clock).  OSDs refuse ops from these (OSDMap
        # blocklist)
        self.blocklist: dict[str, float] = {}

    def is_blocklisted(self, instance_id: str) -> bool:
        """Any entry in the map fences, whatever this daemon's clock
        says of its expiry: the monitor's tick removes expired entries
        by an incremental, so every OSD unfences at the same epoch."""
        return instance_id in self.blocklist

    # -- queries ------------------------------------------------------------
    def exists(self, osd: int) -> bool:
        return osd in self.osds

    def is_up(self, osd: int) -> bool:
        return osd in self.osds and self.osds[osd].up

    def get_up_thru(self, osd: int) -> int:
        info = self.osds.get(osd)
        return 0 if info is None else info.up_thru

    def get_pool_by_name(self, name: str) -> PoolSpec | None:
        pid = self.pool_names.get(name)
        return None if pid is None else self.pools.get(pid)

    def osd_weights(self) -> list[int]:
        """CRUSH input weight vector: 0 for out, reweight otherwise.

        Down-but-IN OSDs KEEP their weight (the reference feeds only
        in/out + reweight into CRUSH; up/down is applied by the post-
        filter in pg_to_up_acting).  Zeroing a down OSD here would
        re-run CRUSH without it and RESHUFFLE the raw placement -- for
        EC pools the acting-set position IS the shard id, so a reshuffle
        relabels every surviving OSD's stored shard bytes (the
        degraded-read corruption pinned by tests/test_ec_degraded.py).

        Memoized per mutation generation (the vector used to be
        rebuilt over max_osd on EVERY pg_to_up_acting call); callers
        treat the returned list as read-only."""
        if (self._weights_memo is not None
                and self._weights_memo[0] == self._mutation_gen):
            return self._weights_memo[1]
        n = max([self.max_osd] + [o + 1 for o in self.osds]) if self.osds \
            else self.max_osd
        w = [0] * n
        for osd, info in self.osds.items():
            if info.in_cluster:
                w[osd] = info.weight
        self._weights_memo = (self._mutation_gen, w)
        return w

    # -- placement cache ----------------------------------------------------
    @property
    def placement_perf(self):
        """This map's 'placement_cache' counter set (bulk_recomputes,
        fused/scalar pools, recompute time, lookups, delta_pgs).
        Daemons adopt it into their PerfCountersCollection so `perf
        dump` and the chaos driver see it."""
        if self._placement_perf is None:
            from ..common.perf import PerfCounters
            self._placement_perf = PerfCounters("placement_cache")
        return self._placement_perf

    def peek_placement_cache(self):
        """The built PGMapping for the CURRENT generation, or None --
        never triggers a build (map-change handlers capture the
        previous table for delta() before applying an incremental)."""
        if (self._pcache is not None
                and self._pcache[0] == self._mutation_gen):
            return self._pcache[1]
        return None

    def placement_cache(self):
        """The full-cluster placement table for this epoch, building
        it (one bulk recompute) on first use per mutation generation,
        on ``self.device``: a RuntimeError when that is CUDA (the
        default) and there is no card."""
        cached = self.peek_placement_cache()
        if cached is not None:
            return cached
        from .pg_mapping import PGMapping, shared_table
        pm = (shared_table(self, perf=self.placement_perf)
              if self.shared_tables
              else PGMapping.build(self, perf=self.placement_perf))
        self._pcache = (self._mutation_gen, pm)
        return pm

    def invalidate_placement_cache(self) -> None:
        """Out-of-band map surgery (tests, offline tools editing
        fields directly) must call this; apply_incremental and the
        dict loaders bump the generation themselves.  The CRUSH map's
        cached structure digest and mappers go too, so an edit made to
        it in place keys a new table (``pg_mapping.table_key``)."""
        self._mutation_gen += 1
        self.crush.__dict__.pop("_structure_digest", None)
        self.crush.__dict__.pop("_vc_cache", None)

    # -- placement ----------------------------------------------------------
    def object_to_pg(self, pool_id: int, name: str, nspace: str = "",
                     key: str = "") -> tuple[int, int]:
        pool = self.pools[pool_id]
        ps = pool.hash_key(key or name, nspace)
        return pool_id, ps

    def _apply_upmap(self, pgid: str, raw: list[int]) -> list[int]:
        """Rewrite the raw CRUSH result with the pg's upmap items
        (OSDMap.cc:2705 _apply_upmap): each (from, to) replaces one
        occurrence, skipped when `to` already appears in the set."""
        items = self.pg_upmap_items.get(pgid)
        if not items:
            return raw
        out = list(raw)
        for frm, to in items:
            if to in out or not self.exists(to):
                continue
            for i, o in enumerate(out):
                if o == frm:
                    out[i] = to
                    break
        return out

    def pg_to_up_acting(self, pool_id: int,
                        ps: int) -> tuple[list[int], list[int]]:
        """(up, acting) for a pg (OSDMap.cc:2928 _pg_to_up_acting_osds).

        up = CRUSH + upmap + down-filter; acting = the pg_temp override
        when one is set (the serving set during backfill), else up.

        Served from the epoch-memoized full-cluster table (OSDMapMapping
        analog, mon/pg_mapping.py): CRUSH runs once per map generation
        in bulk, and this is an O(1) array read.  The per-PG scalar
        pipeline survives as _pg_to_up_acting_scalar -- the oracle the
        parity suite holds the table to, entry for entry."""
        pm = self.placement_cache()
        if self._placement_perf is not None:
            self._placement_perf.inc("lookups")
        return pm.lookup(pool_id, ps)

    def _pg_to_up_acting_scalar(self, pool_id: int,
                                ps: int) -> tuple[list[int], list[int]]:
        """Reference per-PG pipeline (one scalar crush_do_rule)."""
        pool = self.pools[pool_id]
        pgid = self.pg_name(pool_id, ps)
        pps = pool.raw_pg_to_pps(pool.raw_pg_to_pg(ps))
        weights = self.osd_weights()
        raw = crush_do_rule(self.crush, pool.crush_rule, pps, pool.size,
                            weights)
        raw = self._apply_upmap(pgid, raw)
        # filter nonexistent/down osds (_raw_to_up_osds, OSDMap.cc:2773):
        # replicated pools shift the survivors up; EC pools keep holes
        # because the acting-set position IS the shard id.  Holes are
        # NORMALIZED to -1 here -- every consumer downstream (pg.py
        # role/shard logic, clients, tools) uses the `o >= 0` test, and
        # a raw CRUSH_ITEM_NONE (2^31-1) leaking through reads as a
        # live osd id (the no-primary wedge the degraded-read repro hit)
        def live(o: int) -> bool:
            return o != CRUSH_ITEM_NONE and o >= 0 and self.is_up(o)
        if pool.can_shift_osds():
            up = [o for o in raw if live(o)]
        else:
            up = [o if live(o) else -1 for o in raw]
        temp = self.pg_temp.get(pgid)
        if temp:
            acting = [o if live(o) else -1 for o in temp]
            if pool.can_shift_osds():
                acting = [o for o in acting if o >= 0]
            if not acting:
                acting = up
        else:
            acting = up
        return up, acting

    def pg_to_up_acting_osds(self, pool_id: int, ps: int) -> list[int]:
        """Acting set (what clients target); see pg_to_up_acting."""
        return self.pg_to_up_acting(pool_id, ps)[1]

    def pg_primary(self, up: list[int]) -> int | None:
        # holes are -1 post-normalization; tolerate raw NONE too
        for o in up:
            if o >= 0 and o != CRUSH_ITEM_NONE:
                return o
        return None

    def pg_name(self, pool_id: int, ps: int) -> str:
        pool = self.pools[pool_id]
        return f"{pool_id}.{pool.raw_pg_to_pg(ps):x}"

    def pg_ids(self, pool_id: int) -> list[str]:
        pool = self.pools[pool_id]
        return [f"{pool_id}.{i:x}" for i in range(pool.pg_num)]

    # -- mutation -----------------------------------------------------------
    def apply_incremental(self, inc: Incremental) -> None:
        assert inc.epoch == self.epoch + 1, (inc.epoch, self.epoch)
        self.epoch = inc.epoch
        if inc.new_max_osd is not None:
            self.max_osd = inc.new_max_osd
        for osd, addr in inc.new_up.items():
            info = self.osds.setdefault(osd, OsdInfo())
            info.up = True
            info.addr = tuple(addr) if addr else None
        for osd in inc.new_down:
            info = self.osds.get(osd)
            if info is not None:
                info.up = False
                info.down_at_epoch = inc.epoch
        for osd in inc.new_in:
            self.osds.setdefault(osd, OsdInfo()).in_cluster = True
        for osd in inc.new_out:
            info = self.osds.get(osd)
            if info is not None:
                info.in_cluster = False
        for osd, w in inc.new_weights.items():
            self.osds.setdefault(osd, OsdInfo()).weight = w
        for osd, uuid in inc.new_uuids.items():
            self.osds.setdefault(osd, OsdInfo()).uuid = uuid
        for osd, host in inc.new_hosts.items():
            self.osds.setdefault(osd, OsdInfo()).host = host
        for pid, pd in inc.new_pools.items():
            spec = PoolSpec(**pd)
            self.pools[pid] = spec
            self.pool_names[spec.name] = pid
        for pid in inc.removed_pools:
            spec = self.pools.pop(pid, None)
            if spec:
                self.pool_names.pop(spec.name, None)
            # pool ids are reused (max+1): stale placement overrides
            # must not leak onto a future pool with the same id
            prefix = f"{pid}."
            for d in (self.pg_temp, self.pg_upmap_items):
                for pgid in [k for k in d if k.startswith(prefix)]:
                    d.pop(pgid)
        for iid, exp in inc.new_blocklist.items():
            self.blocklist[iid] = exp
        for iid in inc.old_blocklist:
            self.blocklist.pop(iid, None)
        if inc.new_crush is not None:
            self.crush = crush_map_from_dict(inc.new_crush)
        for name, profile in inc.new_ec_profiles.items():
            self.ec_profiles[name] = dict(profile)
        for name in inc.removed_ec_profiles:
            self.ec_profiles.pop(name, None)
        for osd, e in inc.new_up_thru.items():
            info = self.osds.setdefault(osd, OsdInfo())
            info.up_thru = max(info.up_thru, e)
        for pgid, osds in inc.new_pg_temp.items():
            if osds:
                self.pg_temp[pgid] = list(osds)
            else:
                self.pg_temp.pop(pgid, None)
        for pid, snaps in inc.new_pool_snaps.items():
            pool = self.pools.get(pid)
            if pool is not None:
                pool.snap_seq = max(pool.snap_seq,
                                    int(snaps.get("snap_seq", 0)))
                for sid in snaps.get("removed", []):
                    if sid not in pool.removed_snaps:
                        pool.removed_snaps.append(sid)
        for pgid, items in inc.new_pg_upmap_items.items():
            self.pg_upmap_items[pgid] = [tuple(i) for i in items]
        for pgid in inc.removed_pg_upmap_items:
            self.pg_upmap_items.pop(pgid, None)
        # a placement-AFFECTING incremental -- osd state, weights,
        # pools, crush, pg_temp, upmap -- retires the memoized
        # placement table and weight vector for the previous
        # generation; a placement-NEUTRAL one (up_thru/blocklist/...)
        # carries both forward, so the peering storm after a pool
        # create (one up_thru epoch per PG) costs zero rebuilds
        pcache, weights = self._pcache, self._weights_memo
        self._mutation_gen += 1
        if inc.placement_neutral():
            if pcache is not None and pcache[0] == self._mutation_gen - 1:
                self._pcache = (self._mutation_gen, pcache[1])
            if weights is not None and weights[0] == self._mutation_gen - 1:
                self._weights_memo = (self._mutation_gen, weights[1])

    # -- serialization ------------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "epoch": self.epoch,
            "max_osd": self.max_osd,
            "osds": {str(o): {"up": i.up, "in": i.in_cluster,
                              "weight": i.weight, "addr": i.addr,
                              "uuid": i.uuid, "host": i.host,
                              "down_at": i.down_at_epoch,
                              "up_thru": i.up_thru}
                     for o, i in self.osds.items()},
            "pools": {str(p): asdict(s) for p, s in self.pools.items()},
            "crush": crush_to_dict(self.crush),
            "ec_profiles": self.ec_profiles,
            "pg_temp": self.pg_temp,
            "pg_upmap_items": {k: [list(i) for i in v]
                               for k, v in self.pg_upmap_items.items()},
            "blocklist": dict(self.blocklist),
        }

    @classmethod
    def from_dict(cls, d: dict, device=None,
                  shared_tables: bool = False) -> "OSDMap":
        m = cls(device, shared_tables)
        m.epoch = d["epoch"]
        m.max_osd = d["max_osd"]
        for o, i in d.get("osds", {}).items():
            m.osds[int(o)] = OsdInfo(
                up=i["up"], in_cluster=i["in"], weight=i["weight"],
                addr=tuple(i["addr"]) if i.get("addr") else None,
                uuid=i.get("uuid", ""), host=i.get("host", ""),
                down_at_epoch=i.get("down_at", 0),
                up_thru=i.get("up_thru", 0))
        for p, s in d.get("pools", {}).items():
            spec = PoolSpec(**s)
            m.pools[int(p)] = spec
            m.pool_names[spec.name] = int(p)
        m.crush = crush_map_from_dict(d["crush"])
        m.blocklist = dict(d.get("blocklist", {}))
        m.ec_profiles = dict(d.get("ec_profiles", {}))
        m.pg_temp = {k: list(v) for k, v in d.get("pg_temp", {}).items()}
        m.pg_upmap_items = {k: [tuple(i) for i in v]
                            for k, v in d.get("pg_upmap_items",
                                              {}).items()}
        return m
