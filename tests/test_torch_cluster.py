"""The port's cluster against ceph_tpu's, driven by the same scripts.

Each case boots a monitor, OSDs and a librados client of each package on
loopback (``tests/torch_cluster_cases.py``), runs one script on both and
holds the port's results against the reference's: every read equals its
source, the stored objects (bytes and CRC tags, by OSD, object and shard
position) are equal, and so are the counters that do not depend on
timing.  The port runs on ``device="cpu"`` and, for its EC pools, the
``cuda`` plugin; without ``device`` its daemons raise on a machine
without CUDA.
"""

import asyncio

import numpy as np
import pytest
import torch

from torch_cluster_cases import (HEARTBEAT, PORT, Cluster, RawCluster, Side,
                                 on_both, payloads, read_result, run,
                                 wait_for)

torch.set_num_threads(1)


def test_daemons_without_a_device_raise_without_cuda(monkeypatch):
    """No silent CPU: the daemons, the client and the cluster harness
    resolve CUDA by default and raise where there is none."""
    from ceph_tpu_torch.client import Rados
    from ceph_tpu_torch.ec import registry
    from ceph_tpu_torch.loadgen.cluster import SimCluster
    from ceph_tpu_torch.mon import Monitor
    from ceph_tpu_torch.osd import OSD
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: OSD(), lambda: Monitor(),
                 lambda: Rados(("127.0.0.1", 1)),
                 lambda: registry().factory("cuda", {"k": "2", "m": "1"})):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    with pytest.raises(RuntimeError, match="CUDA"):
        run(SimCluster.create(1))
    # the device travels beside the profile, never inside it
    codec = registry().factory("cuda", {"k": "2", "m": "1"}, device="cpu")
    assert codec.device.type == "cpu" and "device" not in codec.get_profile()


def test_every_map_of_a_daemon_is_on_its_device():
    """The OSD's, the monitor's and the client's maps build their tables
    on the daemon's device, full-map ingests included."""
    async def main():
        c = await Cluster.boot(Side(PORT), 2)
        try:
            await c.rados.pool_create("p", pg_num=4, size=2)
            await wait_for(lambda: all(
                o.osdmap.epoch == c.mon.osdmap.epoch for o in c.osds), 10,
                "maps to settle")
            maps = [c.mon.osdmap, c.rados.objecter.osdmap] + \
                [o.osdmap for o in c.osds]
            for m in maps:
                assert torch.device(m.device).type == "cpu"
                assert m.placement_cache().device.type == "cpu"
            c.osds[0]._apply_full_map(
                {**c.mon.osdmap.to_dict(), "epoch": c.mon.osdmap.epoch + 1})
            assert torch.device(c.osds[0].osdmap.device).type == "cpu"
            assert c.osds[0].codec_batcher.device.type == "cpu"
        finally:
            await c.stop()
    run(main())


async def replicated_io(side):
    """Replicated pool I/O through librados: writes, appends, offset
    writes, xattrs, omap, stat, remove, listing."""
    c = await Cluster.boot(side, 3)
    try:
        pool = await c.rados.pool_create("rep", pg_num=8, size=3,
                                         min_size=2)
        io = await c.rados.open_ioctx("rep")
        src = payloads(1, 6, 3000)
        for oid, data in src.items():
            await io.write_full(oid, data)
        await io.append("obj-0", b"-tail")
        src["obj-0"] += b"-tail"
        await io.write("obj-1", b"PATCH", offset=100)
        b = bytearray(src["obj-1"])
        b[100:105] = b"PATCH"
        src["obj-1"] = bytes(b)
        await io.set_xattr("obj-2", "lang", b"en")
        await io.set_omap("obj-2", {"k1": b"v1", "k2": b"v2"})
        await io.remove("obj-5")
        del src["obj-5"]
        reads = {oid: await io.read(oid) for oid in src}
        ranged = await io.read("obj-3", length=50, offset=10)
        assert ranged == src["obj-3"][10:60]
        return {"reads_ok": reads == src,
                "sizes": {o: (await io.stat(o))["size"] for o in src},
                "xattr": await io.get_xattr("obj-2", "lang"),
                "omap": await io.get_omap("obj-2"),
                "listed": sorted(await io.list_objects()),
                "stored": c.stored(pool)}
    finally:
        await c.stop()


def test_replicated_pool_io_matches():
    ref, port = run(on_both(replicated_io))
    assert ref["reads_ok"] and port["reads_ok"]
    assert port["stored"] and port == ref


async def ec21_io(side):
    """EC k=2,m=1 on 3 OSDs: full writes of unaligned sizes, an RMW
    overwrite inside an object, an append, ranged reads."""
    c = await Cluster.boot(side, 3)
    try:
        pool = await c.ec_pool("ec", 2, 1, pg_num=4)
        io = await c.rados.open_ioctx("ec")
        src = payloads(2, 5, 20000)
        for oid, data in src.items():
            await io.write_full(oid, data)
        # counted before any read: a read's decodes depend on which shards
        # answer first (hedged sub-reads), a full write's encodes do not
        stripes = c.counter("ec_batch", "stripes")
        await io.write("obj-1", b"X" * 3000, offset=5000)
        b = bytearray(src["obj-1"])
        b[5000:8000] = b"X" * 3000
        src["obj-1"] = bytes(b)
        await io.append("obj-2", b"A" * 4500)
        src["obj-2"] += b"A" * 4500
        reads = {oid: await io.read(oid) for oid in src}
        ranged = [await io.read("obj-3", length=n, offset=o)
                  for o, n in ((0, 100), (4095, 2), (12345, 7000))]
        return {"reads_ok": reads == src,
                "ranged_ok": ranged == [src["obj-3"][o:o + n] for o, n in
                                        ((0, 100), (4095, 2),
                                         (12345, 7000))],
                "stored": c.stored(pool), "stripes": stripes}
    finally:
        await c.stop()


def test_ec21_pool_io_matches():
    ref, port = run(on_both(ec21_io))
    assert ref["reads_ok"] and ref["ranged_ok"]
    assert port["reads_ok"] and port["ranged_ok"]
    assert port["stripes"] == 5 * -(-20000 // (2 * 4096))
    # every object has its three shards, each under its write-time tag
    assert len(port["stored"]) == 3 * 5
    assert port == ref


async def cls_calls(side):
    """CALL ops through osd/cls: numops and version, an EINVAL from a
    method and a class that does not exist."""
    import json
    c = await Cluster.boot(side, 3)
    try:
        await c.rados.pool_create("cls", pg_num=4, size=2, min_size=1)
        io = await c.rados.open_ioctx("cls")
        await io.write_full("counter", b"")
        out = [await io.exec("counter", "numops", "add",
                             json.dumps({"key": "n", "value": 5}).encode()),
               await io.exec("counter", "numops", "mul",
                             json.dumps({"key": "n", "value": 3}).encode()),
               await io.exec("counter", "version", "inc", b"")]
        try:
            await io.exec("counter", "numops", "div",
                          json.dumps({"key": "n", "value": 0}).encode())
            err = None
        except side.RadosError as e:
            err = e.errno_name
        try:
            await io.exec("counter", "nosuchclass", "m", b"")
            missing = None
        except side.RadosError as e:
            missing = e.errno_name
        return {"out": out, "div0": err, "missing": missing,
                "omap": await io.get_omap("counter")}
    finally:
        await c.stop()


def test_call_op_through_cls_matches():
    ref, port = run(on_both(cls_calls))
    assert port["out"][:2] == [b"5", b"15"]
    assert port["div0"] == "EINVAL" and port["missing"] == "EOPNOTSUPP"
    assert port == ref


async def host_down_epoch(side):
    """A host-down epoch after a placement-neutral one: each OSD's sweep
    visits only ``delta``'s PGs, and the neutral epoch none."""
    c = await Cluster.boot(side, 5, osd_config=HEARTBEAT)
    pg_cls = type(c.osds[0]).__init__.__globals__["PG"]
    visits = {}
    orig = pg_cls.update_mapping

    def counting(self, up, acting, epoch):
        visits[self.osd.whoami] = visits.get(self.osd.whoami, 0) + 1
        return orig(self, up, acting, epoch)

    try:
        await c.rados.pool_create("rep", pg_num=16, size=3)
        await c.ec_pool("ec", 2, 2, pg_num=8)
        await wait_for(lambda: all(
            o.osdmap.epoch == c.mon.osdmap.epoch for o in c.osds), 10,
            "maps to settle")
        pg_cls.update_mapping = counting
        deltas0 = [c.counter("placement_cache", "delta_pgs")]
        before = {o.whoami: o.osdmap.placement_cache() for o in c.osds}
        # placement-neutral: fencing a client moves no PG
        await c.rados.mon_command("osd blocklist",
                                  {"id": "client.gone:1"})
        await wait_for(lambda: all(
            o.osdmap.epoch == c.mon.osdmap.epoch for o in c.osds), 10,
            "the blocklist epoch")
        neutral = (dict(visits), c.counter("placement_cache", "delta_pgs")
                   - deltas0[0])
        visits.clear()
        victim = 3
        live = [o for o in c.osds if o.whoami != victim]
        d0 = sum(int(o.perf.dump()["placement_cache"].get("delta_pgs", 0))
                 for o in live)
        prev = {o.whoami: o.osdmap.placement_cache() for o in live}
        await c.kill(victim)
        await wait_for(lambda: all(
            o.osdmap.epoch == c.mon.osdmap.epoch for o in live), 10,
            "the host-down epoch")
        d1 = sum(int(o.perf.dump()["placement_cache"].get("delta_pgs", 0))
                 for o in live)
        # the brute-force diff of each OSD's two tables
        moved = {}
        for o in live:
            cur = o.osdmap.placement_cache()
            old = {(p, pg): (u, a) for p, pg, u, a in prev[o.whoami].iter_all()}
            moved[o.whoami] = sorted(
                (p, pg) for p, pg, u, a in cur.iter_all()
                if old.get((p, pg)) != (u, a))
        return {"neutral": neutral, "visits": dict(visits),
                "delta_pgs": d1 - d0, "moved": moved,
                "same_table_before": all(
                    before[o.whoami] is not None for o in c.osds)}
    finally:
        pg_cls.update_mapping = orig
        await c.stop()


def test_host_down_epoch_sweeps_only_the_delta():
    ref, port = run(on_both(host_down_epoch))
    assert port["neutral"] == ({}, 0)
    n_moved = sum(len(v) for v in port["moved"].values())
    assert port["delta_pgs"] == n_moved > 0
    # an OSD visits at most the PGs that moved
    for whoami, n in port["visits"].items():
        assert 0 < n <= len(port["moved"][whoami])
    assert port == ref


# -- the reference's datapath cluster tests (tests/test_datapath_cache.py
# :177, :214, :242, :300), on the port's cluster ----------------------------

async def _ec_cluster(osd_config=None):
    c = await RawCluster.boot(Side(PORT), 3, osd_config=osd_config)
    await c.command("osd erasure-code-profile set",
                    {"name": "prof",
                     "profile": {"plugin": "cuda", "k": "2", "m": "1",
                                 "technique": "reed_sol_van"}})
    await c.command("osd pool create",
                    {"name": "ecpool", "type": "erasure",
                     "pg_num": 2, "erasure_code_profile": "prof"})
    return c


async def _read(c, oid, off=0, length=None):
    reply = await c.osd_op("ecpool", oid, [
        {"op": "read", "off": off, "len": length}])
    r, data = read_result(reply)
    assert r.get("ok"), r
    return data


def test_cached_reads_byte_identical_across_overwrite_and_truncate():
    from ceph_tpu_torch.os.device_cache import PERF

    async def main():
        c = await _ec_cluster()
        try:
            rng = np.random.default_rng(5)
            base = rng.integers(0, 256, 5 * 8192, dtype=np.uint8).tobytes()
            await c.osd_op("ecpool", "obj", [
                {"op": "writefull", "data": base}])
            h0 = PERF.get("hits")
            warm1 = await _read(c, "obj")
            warm2 = await _read(c, "obj")
            assert warm1 == base and warm2 == base
            assert PERF.get("hits") > h0, "reads never hit the cache"
            patch = b"P" * 5000
            await c.osd_op("ecpool", "obj", [
                {"op": "write", "off": 3000, "data": patch}])
            shadow = bytearray(base)
            shadow[3000:8000] = patch
            assert await _read(c, "obj") == bytes(shadow)
            await c.osd_op("ecpool", "obj", [
                {"op": "truncate", "size": 9000}])
            assert await _read(c, "obj") == bytes(shadow[:9000])
            await c.osd_op("ecpool", "obj", [
                {"op": "write", "off": 20000, "data": b"Z" * 100}])
            want = bytearray(shadow[:9000])
            want.extend(b"\0" * (20000 - 9000))
            want.extend(b"Z" * 100)
            assert await _read(c, "obj") == bytes(want)
        finally:
            await c.stop()
    run(main())


def test_eviction_pressure_never_breaks_reads():
    from ceph_tpu_torch.os.device_cache import PERF

    async def main():
        c = await _ec_cluster(osd_config={
            "osd_datapath_cache_bytes": 16 * 1024})
        try:
            rng = np.random.default_rng(6)
            objs = {f"o{i}": rng.integers(0, 256, 3 * 8192,
                                          dtype=np.uint8).tobytes()
                    for i in range(6)}
            for oid, data in objs.items():
                await c.osd_op("ecpool", oid, [
                    {"op": "writefull", "data": data}])
            ev0 = PERF.get("evictions")
            for _ in range(2):
                for oid, data in objs.items():
                    assert await _read(c, oid) == data
            assert PERF.get("evictions") > ev0, \
                "the pressure workload never evicted"
            for osd in c.osds:
                if osd.shard_cache is not None:
                    assert (osd.shard_cache.used_bytes
                            <= osd.shard_cache.max_bytes)
        finally:
            await c.stop()
    run(main())


def test_kill_revive_never_serves_stale_resident_bytes():
    """An OSD killed with hot residency comes back cold: the object is
    overwritten while it is down, and the revived OSD (fresh cache,
    log-driven recovery) serves the new bytes."""
    from ceph_tpu_torch.osd.osd import OSD

    async def main():
        c = await _ec_cluster()
        try:
            rng = np.random.default_rng(7)
            base = rng.integers(0, 256, 4 * 8192, dtype=np.uint8).tobytes()
            await c.osd_op("ecpool", "kv", [
                {"op": "writefull", "data": base}])
            await _read(c, "kv")
            pgid, primary, up = c.target_for("ecpool", "kv")
            victim = next(o for o in c.osds
                          if o.whoami in up and o.whoami != primary)
            vid, vuuid, vstore, vhost = (victim.whoami, victim.uuid,
                                         victim.store, victim.host)
            assert victim.shard_cache is not None
            assert len(victim.shard_cache) > 0, "victim never cached"
            await victim.stop()
            c.osds = [o for o in c.osds if o.whoami != vid]
            await wait_for(lambda: not c.mon.osdmap.is_up(vid), 20,
                           "the victim marked down")
            new = rng.integers(0, 256, 4 * 8192, dtype=np.uint8).tobytes()
            await c.osd_op("ecpool", "kv", [
                {"op": "writefull", "data": new}])
            revived = OSD(uuid=vuuid, whoami=vid, store=vstore, host=vhost,
                          device="cpu")
            await revived.start(c.mon.msgr.addr)
            c.osds.append(revived)
            assert revived.shard_cache is not None
            assert len(revived.shard_cache) == 0, \
                "revived OSD must start cold"
            await wait_for(lambda: c.mon.osdmap.is_up(vid), 30,
                           "the revived OSD up")
            for _ in range(50):
                if await _read(c, "kv") == new:
                    break
                await asyncio.sleep(0.2)
            assert await _read(c, "kv") == new
        finally:
            await c.stop()
    run(main())


def test_write_path_populates_cache_and_donation_is_safe():
    """A full-stripe write's encoded shards become resident on every
    acting OSD, tagged with the fused launch's CRC, and the resident
    bytes are the committed bytes."""
    from ceph_tpu_torch.os.device_cache import PERF

    async def main():
        c = await _ec_cluster()
        try:
            rng = np.random.default_rng(8)
            data = rng.integers(0, 256, 3 * 8192, dtype=np.uint8).tobytes()
            p0 = PERF.get("puts")
            await c.osd_op("ecpool", "w", [
                {"op": "writefull", "data": data}])
            assert PERF.get("puts") >= p0 + 3
            pgid, _, _ = c.target_for("ecpool", "w")
            seen = 0
            for osd in c.osds:
                e = osd.shard_cache.get(f"pg_{pgid}", "w") \
                    if pgid in osd.pgs else None
                if e is not None:
                    seen += 1
                    assert e.size == len(data)
                    assert e.crc is not None
                    assert bytes(e.buf) == osd.store.read(
                        f"pg_{pgid}", "w", 0, None)
            assert seen == 3
        finally:
            await c.stop()
    run(main())
