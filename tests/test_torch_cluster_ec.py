"""The port's EC cluster against ceph_tpu's: RS k=8,m=3 on 12 OSDs through
kill, degraded reads, a degraded write, revive and recovery, then scrub;
and ``scrub_ec`` finding and repairing a corrupted shard.

The same script runs on a cluster of each package
(``tests/torch_cluster_cases.py``; the port on ``device="cpu"`` with the
``cuda`` plugin, the reference with its ``tpu`` plugin).  Every read must
equal its source; the stored shards and CRC tags (by OSD, object and
shard position, the revived OSD's included), the stripes encoded and
decoded, and the scrub verdicts must be equal.
"""

import asyncio

import numpy as np
import torch

from torch_cluster_cases import (HEARTBEAT, Cluster, on_both, payloads, run,
                                 wait_for)

torch.set_num_threads(1)

K, M, N_OSDS, PG_NUM = 8, 3, 12, 8
N_OBJECTS, OBJ_BYTES = 16, 64 << 10


async def _write_all(io, src: dict, concurrency: int = 8) -> None:
    sem = asyncio.Semaphore(concurrency)

    async def one(oid, data):
        async with sem:
            await asyncio.wait_for(io.write_full(oid, data), 30)
    await asyncio.gather(*(one(o, d) for o, d in src.items()))


async def _read_all(io, src: dict) -> bool:
    got = {}
    for oid in src:
        got[oid] = await asyncio.wait_for(io.read(oid), 30)
    return got == src


async def _scrub_all(c: Cluster, pool_id: int, repair: bool = False):
    """scrub_ec on every PG of the pool, on its primary: (pgid, objects,
    inconsistent, repaired) a PG."""
    out = []
    for o in c.osds:
        for pgid, pg in sorted(o.pgs.items()):
            if pgid.startswith(f"{pool_id}.") and pg.is_primary():
                res = await asyncio.wait_for(
                    c.side.scrub.scrub_ec(pg, repair=repair), 30)
                out.append((pgid, res.objects_scrubbed,
                            sorted(res.inconsistent), list(res.repaired)))
    return sorted(out)


# Sub-reads unhedged: a hedged read decodes from the first k shards to
# answer, so its stripes decoded depend on timing; unhedged, a read decodes
# exactly when a shard it needs is down, and both clusters' counts agree.
UNHEDGED = {**HEARTBEAT, "osd_ec_hedge_enabled": False}


async def ec83_drive(side):
    c = await Cluster.boot(side, N_OSDS, osd_config=UNHEDGED)
    try:
        pool = await c.ec_pool("ec83", K, M, pg_num=PG_NUM)
        io = await c.rados.open_ioctx("ec83")
        src = payloads(83, N_OBJECTS, OBJ_BYTES)
        out = {}
        await _write_all(io, src)
        out["read"] = await _read_all(io, src)
        out["stripes_written"] = c.counter("ec_batch", "stripes")
        # kill a shard holder of obj-0 that is not its primary; it stays
        # in, so its PGs run degraded and are not remapped
        _, primary, acting = c.target(pool, "obj-0")
        victim = next(o for o in acting if o != primary)
        index = next(i for i, o in enumerate(c.osds) if o.whoami == victim)
        token = await c.kill(victim)
        out["degraded_read"] = await _read_all(io, src)
        # a degraded write: 10 of 11 shards are up, min_size is k+1
        new = payloads(84, N_OBJECTS // 2, OBJ_BYTES)
        await _write_all(io, new)
        src.update(new)
        out["degraded_read_after_write"] = await _read_all(io, src)
        out["stripes_degraded"] = c.counter("ec_batch", "stripes")
        stale = c.stored(pool, [o for o in c.osds if o.whoami != victim])
        await c.revive(token, index)
        await wait_for(lambda: all(
            o.osdmap.epoch == c.mon.osdmap.epoch for o in c.osds), 10,
            "maps to settle")
        out["read_after_recovery"] = await _read_all(io, src)
        out["stored"] = c.stored(pool)
        # every shard the live OSDs held stays; the revived OSD holds
        # the shards it missed
        out["kept"] = all(out["stored"].get(k) == v
                          for k, v in stale.items())
        out["revived_shards"] = sum(1 for (w, _, _) in out["stored"]
                                    if w == victim)
        out["scrub"] = await _scrub_all(c, pool)
        out["scrub_fast"] = int(
            c.side.device_cache.PERF.get("scrub_fast_verifies"))
        return out
    finally:
        await c.stop()


def test_ec83_kill_degraded_revive_recover_scrub_matches():
    c0 = {}
    for pkg in ("ceph_tpu", "ceph_tpu_torch"):
        import importlib
        c0[pkg] = importlib.import_module(
            f"{pkg}.os.device_cache").PERF.get("scrub_fast_verifies")
    ref, port = run(on_both(ec83_drive))
    for side in (ref, port):
        assert side["read"] and side["degraded_read"]
        assert side["degraded_read_after_write"]
        assert side["read_after_recovery"] and side["kept"]
        assert side["revived_shards"] == N_OBJECTS
        assert all(not bad for _, _, bad, _ in side["scrub"])
        assert sum(n for _, n, _, _ in side["scrub"]) == N_OBJECTS
    ref["scrub_fast"] -= c0["ceph_tpu"]
    port["scrub_fast"] -= c0["ceph_tpu_torch"]
    stripe = K * 4096                       # stripe_unit 4 KiB
    assert port["stripes_written"] == sum(
        -(-len(d) // stripe) for d in payloads(83, N_OBJECTS, OBJ_BYTES)
        .values())
    assert len(port["stored"]) == N_OBJECTS * (K + M)
    assert port == ref


async def scrub_repair(side):
    """``tests/test_scrub.py``'s EC case: a rotted shard is found by the
    re-encode comparison, repaired, and the next scrub is clean; the
    primary's resident shard is checked from its device view."""
    c = await Cluster.boot(side, 4)
    try:
        pool = await c.ec_pool("ec", 2, 1, pg_num=2)
        io = await c.rados.open_ioctx("ec")
        payload = bytes(range(256)) * 64
        await io.write_full("obj", payload)
        await io.write_full("other", payload[::-1])
        pgid, primary, acting = c.target(pool, "obj")
        pg = c.osd(primary).pgs[pgid]
        resident0 = int(c.side.device_cache.PERF.get("scrub_fast_verifies"))
        clean0 = await c.side.scrub.scrub_pg(pg)
        fast = int(c.side.device_cache.PERF.get("scrub_fast_verifies")) \
            - resident0
        shard_osd = next(c.osd(o) for o in acting if o != primary)
        txn = c.side.Transaction()
        txn.write(f"pg_{pgid}", "obj", 0, b"\xff" * 16)
        shard_osd.store.queue_transaction(txn)
        res = await c.side.scrub.scrub_pg(pg, repair=True)
        verdict = (res.clean, dict(res.inconsistent), list(res.repaired))
        after = await c.side.scrub.scrub_pg(pg)
        return {"clean_before": clean0.clean, "fast": fast,
                "verdict": verdict, "bad_shard": acting.index(
                    shard_osd.whoami),
                "read": await io.read("obj") == payload,
                "clean_after": after.clean,
                "stored": c.stored(pool)}
    finally:
        await c.stop()


def test_scrub_ec_detects_and_repairs_a_rotted_shard_alike():
    ref, port = run(on_both(scrub_repair))
    clean, inconsistent, repaired = port["verdict"]
    assert port["clean_before"] and port["fast"] >= 1
    assert not clean and repaired == ["obj"]
    assert inconsistent["obj"]["bad_shards"] == [port["bad_shard"]]
    assert port["read"] and port["clean_after"]
    assert port == ref


def test_scrub_checks_resident_shards_on_the_device(monkeypatch):
    """The port's scrub_ec hands the primary's resident shard to one
    ``crc32c_resident_batch`` launch over its device view, never the host
    buffer."""
    from ceph_tpu_torch.ops import crc32c_batch
    seen = []
    orig = crc32c_batch.crc32c_resident_batch

    def spy(views):
        seen.extend(views)
        return orig(views)

    monkeypatch.setattr(crc32c_batch, "crc32c_resident_batch", spy)

    async def main():
        from torch_cluster_cases import Side, PORT
        c = await Cluster.boot(Side(PORT), 3)
        try:
            pool = await c.ec_pool("ec", 2, 1, pg_num=1)
            io = await c.rados.open_ioctx("ec")
            data = np.random.default_rng(4).integers(
                0, 256, 9000, dtype=np.uint8).tobytes()
            await io.write_full("o", data)
            pgid, primary, _ = c.target(pool, "o")
            res = await c.side.scrub.scrub_ec(c.osd(primary).pgs[pgid])
            assert res.clean and res.objects_scrubbed == 1
        finally:
            await c.stop()
    run(main())
    assert len(seen) == 1 and isinstance(seen[0], torch.Tensor)
    assert seen[0].dtype == torch.uint8 and seen[0].device.type == "cpu"
