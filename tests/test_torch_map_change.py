"""The map-change path of the port's placement table, which an in-process
cluster runs on every daemon and client handle at every epoch (a deliberate
difference from ``ceph_tpu``, where each holder builds its own table):

* the maps of one process that hold the same placement content read one
  shared table (``pg_mapping.shared_table``), entry for entry each map's own
  build, and a map edited out of band never reads another map's table;
* a mapper uploads each distinct weight vector once;
* a build copies to its device once and back to the host once, and reads
  nothing else back (``meta`` tensors stand in for the card: any other read
  of device data raises);
* on a 12-OSD ``SimCluster`` with client handles, a placement-changing
  epoch costs one build for each distinct map content, not one for each
  holder.

Exactness is the tolerance.
"""

import asyncio
import time

import numpy as np
import pytest
import torch

from ceph_tpu_torch.client import Rados
from ceph_tpu_torch.crush import vectorized
from ceph_tpu_torch.crush.vectorized import VectorCrush
from ceph_tpu_torch.loadgen import SimCluster
from ceph_tpu_torch.mon import pg_mapping as pm_mod
from ceph_tpu_torch.mon.osdmap import OSDMap
from ceph_tpu_torch.mon.pg_mapping import PGMapping
from test_torch_osdmap import DEPTHS, _Launches, make_ref_map, port_of


def shared_copy(m: OSDMap) -> OSDMap:
    """A holder's own copy of ``m`` (as a daemon loads it), opted into the
    shared table."""
    return OSDMap.from_dict(m.to_dict(), device="cpu", shared_tables=True)


def assert_equal_tables(a: PGMapping, b: PGMapping) -> None:
    assert a.tables().keys() == b.tables().keys()
    for pid, arrays in a.tables().items():
        for x, y in zip(arrays, b.tables()[pid]):
            np.testing.assert_array_equal(x, y)


def edit(m: OSDMap, kind: str) -> None:
    """One out-of-band edit of a placement input, then the invalidation the
    map's contract asks for."""
    osd = sorted(m.osds)[1]
    if kind == "weight":
        m.osds[osd].weight = 0x4000 if m.osds[osd].weight != 0x4000 \
            else 0x10000
    elif kind == "down":
        m.osds[osd].up = not m.osds[osd].up
    elif kind == "pg_temp":
        m.pg_temp["1.3"] = [sorted(m.osds)[0], osd]
    elif kind == "upmap":
        up = m.placement_cache().lookup(1, 5)[0]
        free = [o for o in sorted(m.osds) if o not in up]
        m.pg_upmap_items["1.5"] = [(up[0], free[0])]
    elif kind == "crush in place":
        bucket = next(b for b in m.crush.buckets.values()
                      if len(b.items) > 1)
        bucket.item_weights[0] = bucket.item_weights[0] // 2 or 1
    m.invalidate_placement_cache()


@pytest.mark.parametrize("seed,depth", [(41, 2), (42, 3)])
def test_shared_table_equals_each_maps_own_build(monkeypatch, seed, depth):
    """Two holders of one map read one table, equal to the map's own build;
    after an out-of-band edit of one of them, it reads a table equal to its
    own build again, never the other's, and the other keeps its table."""
    monkeypatch.setattr(pm_mod, "_TABLES", {})
    base = port_of(make_ref_map(seed, DEPTHS[depth], extra_pool=True))
    a, b = shared_copy(base), shared_copy(base)
    ta = a.placement_cache()
    assert b.placement_cache() is ta
    assert b.placement_perf.get("shared_tables") == 1
    assert_equal_tables(ta, PGMapping.build(base))
    for kind in ("weight", "down", "pg_temp", "upmap", "crush in place"):
        edit(b, kind)
        tb = b.placement_cache()
        assert tb is not ta, kind
        assert_equal_tables(tb, PGMapping.build(b))
        assert a.placement_cache() is ta
        # a third holder of the edited content reads the edited table
        assert shared_copy(b).placement_cache() is tb, kind


def test_weights_are_uploaded_once_for_each_distinct_vector(monkeypatch):
    """``device_weights`` makes a vector on the mapper's device once for
    each distinct content: repeated launches, and builds whose epochs change
    only the up set, reuse it."""
    m = port_of(make_ref_map(43, DEPTHS[2]))
    vc = VectorCrush(m.crush, 0, device="cpu")
    seeds = pm_mod.pool_seeds(m.pools[1], "cpu")
    before = vectorized.WEIGHT_UPLOADS["crush_map_rule"]
    w1 = list(m.osd_weights())
    w2 = [w // 2 for w in w1]
    rows = [vc.map_device(seeds, 3, w) for w in (w1, w1, w2, w1, w2,
                                                 np.asarray(w1))]
    assert vectorized.WEIGHT_UPLOADS["crush_map_rule"] - before == 2
    assert torch.equal(rows[0], rows[1]) and torch.equal(rows[0], rows[3])
    # builds on the bulk mapper: an epoch that marks an OSD down keeps the
    # weights (down but in), so its build uploads nothing new
    monkeypatch.setattr(pm_mod, "FUSED_MIN_LANES", 1)
    before = vectorized.WEIGHT_UPLOADS["crush_map_rule"]
    PGMapping.build(m)
    first = vectorized.WEIGHT_UPLOADS["crush_map_rule"] - before
    assert first >= 1
    m.osds[sorted(m.osds)[2]].up = not m.osds[sorted(m.osds)[2]].up
    m.invalidate_placement_cache()
    PGMapping.build(m)
    assert vectorized.WEIGHT_UPLOADS["crush_map_rule"] - before == first


def test_a_build_copies_up_once_and_back_once(monkeypatch):
    """On a device whose data cannot be read (``meta``), a build of a map
    with upmap items and pg_temps on two pools copies its inputs up once and
    its table back once, through the counted wrappers, and reads nothing
    else: a ``tolist``, ``item`` or ``cpu`` of device data would raise."""
    launches = _Launches(monkeypatch)
    m = port_of(make_ref_map(44, DEPTHS[2], extra_pool=True))
    assert m.pg_upmap_items and m.pg_temp
    monkeypatch.setattr(pm_mod, "resolve_device", torch.device)
    m.device = "meta"
    real = pm_mod._download
    got = []

    def download(t):
        assert t.device.type == "meta"
        got.append(t.shape)
        return real(torch.zeros(t.shape, dtype=t.dtype))
    monkeypatch.setattr(pm_mod, "_download", download)
    before = dict(pm_mod.TRANSFERS)
    pm = PGMapping.build(m)
    assert launches.n == len(m.pools) and len(got) == 1
    assert pm_mod.TRANSFERS["to_host"] - before["to_host"] == 1
    assert pm_mod.TRANSFERS["to_device"] - before["to_device"] == 1
    assert pm.pg_count() == sum(p.pg_num for p in m.pools.values())
    # and a delta reads the host arrays only
    assert pm.delta(PGMapping.build(m)) == []
    assert pm_mod.TRANSFERS["to_host"] - before["to_host"] == 2


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(asyncio.wait_for(coro, 120))
    finally:
        loop.close()


async def _wait(cond, timeout: float = 30.0) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise TimeoutError("condition never held")
        await asyncio.sleep(0.05)


def test_an_epoch_costs_one_build_for_each_distinct_map(monkeypatch):
    """12 OSDs and 3 client handles in one process: a reweight epoch makes
    every holder read the new table, and the process builds it once; every
    holder reads the same object, equal to the monitor's map's own build."""
    monkeypatch.setattr(pm_mod, "_TABLES", {})
    builds = []
    real = PGMapping.build.__func__

    def counting(cls, osdmap, *args, **kwargs):
        builds.append(pm_mod.table_key(osdmap))
        return real(cls, osdmap, *args, **kwargs)
    monkeypatch.setattr(PGMapping, "build", classmethod(counting))

    async def scenario():
        cluster = await SimCluster.create(12, device="cpu")
        handles = []
        try:
            for i in range(3):
                handles.append(await Rados(cluster.addr, name=f"client.m{i}",
                                           device="cpu").connect())
            await handles[0].pool_create("p", pg_num=16, pool_type="replicated",
                                         size=3, min_size=2)
            ios = [await r.open_ioctx("p") for r in handles]
            for i, io in enumerate(ios):
                await asyncio.wait_for(io.write_full(f"o{i}", b"x" * 64), 30)
            holders = [o.osdmap for o in cluster.osds]
            epoch = cluster.mon.osdmap.epoch
            n_builds = len(builds)
            victim = sorted(cluster.mon.osdmap.osds)[3]
            await handles[0].mon_command("osd reweight", {
                "osd_id": victim, "weight": 0x8000})
            await _wait(lambda: all(o.osdmap.epoch > epoch
                                    for o in cluster.osds))
            for i, io in enumerate(ios):
                await asyncio.wait_for(io.write_full(f"o{i}", b"y" * 64), 30)
            holders = [o.osdmap for o in cluster.osds] + [
                r.objecter.osdmap for r in handles]
            tables = {id(h.placement_cache()) for h in holders
                      if h.epoch == cluster.mon.osdmap.epoch}
            new = builds[n_builds:]
            epochs = cluster.mon.osdmap.epoch - epoch
            assert len(tables) == 1
            # one build for each distinct content, at most one an epoch
            assert len(new) == len(set(new)) and 1 <= len(new) <= epochs
            own = OSDMap.from_dict(cluster.mon.osdmap.to_dict(),
                                   device="cpu")
            assert_equal_tables(holders[0].placement_cache(),
                                PGMapping.build(own))
        finally:
            for r in handles:
                await r.shutdown()
            await cluster.stop()
    run(scenario())
