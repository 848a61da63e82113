"""One CephFS script run on a cluster of each package.

``fs_drive`` boots ``tests/torch_cluster_cases.py``'s cluster with the
CephFS pools (``cephfs_data`` erasure-coded, ``cephfs_metadata``
replicated), MDS ``a`` and then ``b`` (so ``a`` is active on both), and two
mounts, and drives what users do: files in a tree, 4 KiB overwrites through an open handle, appends to one file
from both mounts, a rename and an unlink, the active MDS stopped and the
standby's takeover, then a shard holder of the large file's object 0
killed, every file read degraded, the OSD revived and every PG scrubbed.
A host dict is the oracle of every read.  Every step runs one op at a
time, so the EC counters do not depend on timing.

What the tests compare between the packages: the reads' verdicts, every
stored shard of the data pool and its CRC tag (the MDS allocates the same
inode numbers on both, so the objects have the same names), the objects
the unlink purged, and the counters, taken before the kill.
"""

from __future__ import annotations

import asyncio
import importlib

import numpy as np

from torch_apps_cases import UNHEDGED, counters, scrub_all
from torch_cluster_cases import Cluster, wait_for

TIMEOUT = 60
BLOCK = 4096
BIG = 300_007               # the overwritten file's size: CPU scrubs
                            # run K4's plain version, keep shards small


async def start_mds(side, name: str, addr):
    mds = importlib.import_module(f"{side.pkg}.mds").MDS(name=name,
                                                         **side.dev)
    await asyncio.wait_for(mds.start(addr, create_pools=False), TIMEOUT)
    return mds


async def fs_drive(side, k: int, m: int, n_osds: int, pg_num: int,
                   n_files: int = 6, n_overwrites: int = 8) -> dict:
    CephFS = importlib.import_module(f"{side.pkg}.mds").CephFS
    rng = np.random.default_rng(19)
    c = await Cluster.boot(side, n_osds, osd_config=UNHEDGED)
    mdss, mounts = [], []
    out: dict = {}
    try:
        pool = await c.ec_pool("cephfs_data", k, m, pg_num=pg_num)
        await c.rados.pool_create("cephfs_metadata", pg_num=pg_num)
        addr = c.mon.msgr.addr
        mdss.append(await start_mds(side, "a", addr))
        await wait_for(lambda: mdss[0].state == "active", 30, "mds.a")
        mdss.append(await start_mds(side, "b", addr))
        for name in ("client.one", "client.two"):
            mounts.append(await asyncio.wait_for(
                CephFS(addr, name=name, **side.dev).mount(), TIMEOUT))
        fs, fs2 = mounts

        # -- a tree of files
        files: dict[str, bytes] = {}
        await fs.mkdir("/d")
        await fs.mkdir("/d/e")
        for i in range(n_files):
            n = int(rng.integers(1, 20_000)) * 7
            files[f"/d/{'e/' if i % 2 else ''}f{i}"] = \
                rng.integers(0, 256, n, np.uint8).tobytes()
        files["/big"] = rng.integers(0, 256, BIG, np.uint8).tobytes()
        for p, d in files.items():
            await fs.write_file(p, d)
        out["files"] = all([await fs2.read_file(p) == d
                            for p, d in files.items()])

        # -- 4 KiB overwrites through one handle, one at a time
        f = await fs.open("/big", "r+")
        big = bytearray(files["/big"])
        for off in sorted(rng.choice(len(big) // BLOCK, n_overwrites,
                                     replace=False) * BLOCK):
            d = rng.integers(0, 256, BLOCK, np.uint8).tobytes()
            await f.write(d, int(off))
            big[off:off + BLOCK] = d
        await f.close()
        files["/big"] = bytes(big)
        out["overwrites"] = await fs2.read_file("/big") == files["/big"]

        # -- both mounts append to one file in turns
        await fs.write_file("/log", b"")
        f1, f2 = await fs.open("/log", "a"), await fs2.open("/log", "a")
        recs = []
        for i in range(4):
            for h, tag in ((f1, b"A"), (f2, b"B")):
                rec = tag + str(i).encode() * 300
                await h.write(rec)
                recs.append(rec)
        await f1.close()
        await f2.close()
        files["/log"] = b"".join(recs)
        out["appends"] = await fs.read_file("/log") == files["/log"]

        # -- rename, unlink (its purge through the striper)
        await fs2.rename("/log", "/d/log")
        files["/d/log"] = files.pop("/log")
        gone = next(p for p in files if p.startswith("/d/e/"))
        ino = (await fs.stat(gone))["ino"]
        await fs.unlink(gone)
        del files[gone]
        io = await c.rados.open_ioctx("cephfs_data")
        out["purged"] = [o for o in await io.list_objects()
                         if o.startswith(f"{ino:x}.")]

        # -- MDS failover: a stopped, b takes over
        await mdss[0].stop()
        await wait_for(lambda: mdss[1].state == "active", 40, "mds.b")
        out["after_failover"] = all([await fs2.read_file(p) == d
                                     for p, d in files.items()])
        await fs.mkdir("/post")
        out["counters"] = counters(c)

        # -- a shard holder of /big's object 0 down, reads degraded
        oid = f"{(await fs.stat('/big'))['ino']:x}.{0:016x}"
        _, primary, acting = c.target(pool, oid)
        victim = next(o for o in acting if o != primary)
        index = next(i for i, o in enumerate(c.osds) if o.whoami == victim)
        token = await c.kill(victim)
        out["degraded"] = all([await fs2.read_file(p) == d
                               for p, d in files.items()])
        out["marked_down"] = sorted(
            o for o in c.mon.osdmap.osds if not c.mon.osdmap.is_up(o))
        await c.revive(token, index)
        await wait_for(lambda: all(
            o.osdmap.epoch == c.mon.osdmap.epoch for o in c.osds), 10,
            "maps to settle")
        out["recovered"] = all([await fs.read_file(p) == d
                                for p, d in files.items()])
        out["scrub"] = await scrub_all(c, pool)
        out["stored"] = c.stored(pool)
        out["victim_is_first_down"] = out.pop("marked_down") == [victim]
        return out
    finally:
        for fs_ in mounts:
            await fs_.unmount()
        for mds in mdss:
            if not mds._stopped:
                await mds.stop()
        await c.stop()
