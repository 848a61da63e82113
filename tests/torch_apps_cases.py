"""One client-application script run on a cluster of each package.

``apps_drive`` boots ``tests/torch_cluster_cases.py``'s cluster with an EC
pool and drives it through the applications a user runs over it: an RBD
image (whole-object writes, 4 KiB sub-stripe writes 16 in flight, writes
through the ``ObjectCacher``), a radosstriper file, and RGW
PUT/GET/multipart over loopback HTTP; then it kills a shard holder of the
image's object 0 that is not its primary, reads everything degraded,
revives it, waits for recovery and scrubs every PG.  A host bytearray is
the oracle of every read.

What the tests compare between the packages: the reads' verdicts, the
stored shards and CRC tags keyed by what the objects hold (the image's
object number, the file's object number, the S3 key and part) and never
by the random image, bucket or upload ids, the ETags, and the counters
that do not depend on timing (taken before the cached writes, whose
flushes follow the cache's clock).
"""

from __future__ import annotations

import asyncio
import importlib
import re

import numpy as np

from torch_cluster_cases import HEARTBEAT, Cluster, wait_for

# Sub-reads unhedged, as in test_torch_cluster_ec.py: a hedged read
# decodes from the first k shards to answer, so its counts follow timing.
UNHEDGED = {**HEARTBEAT, "osd_ec_hedge_enabled": False}
IO_DEPTH = 16                       # rbd bench's io-threads
BLOCK = 4096
TIMEOUT = 60

_KEYS = (
    (re.compile(r"^rbd_data\.[0-9a-f]+\.([0-9a-f]{16})$"),
     lambda g: ("rbd", int(g[0], 16))),
    (re.compile(r"^file\.([0-9a-f]{16})$"),
     lambda g: ("file", int(g[0], 16))),
    (re.compile(r"^[0-9a-f]{16}__shadow_(.+)\.[0-9a-f]+\.([0-9a-f]{16})$"),
     lambda g: ("s3", g[0], int(g[1], 16))),
    (re.compile(r"^[0-9a-f]{16}__multipart_(.+)\.[0-9a-f]+\.(\d+)"
                r"\.([0-9a-f]{16})$"),
     lambda g: ("part", g[0], int(g[1]), int(g[2], 16))),
)


def content_key(oid: str):
    """What a data object holds, without the random ids in its name;
    None for metadata (headers, indexes, locks)."""
    for pat, key in _KEYS:
        hit = pat.match(oid)
        if hit:
            return key(hit.groups())
    return None


def stored_by_content(c: Cluster, pool_id: int) -> dict:
    """(content key, shard label) -> sorted [(bytes, CRC tag)] of every
    data object of the pool."""
    out: dict = {}
    for (_, oid, label), val in c.stored(pool_id).items():
        key = content_key(oid)
        if key is not None:
            out.setdefault((key, label), []).append(val)
    return {k: sorted(v) for k, v in out.items()}


def counters(c: Cluster) -> dict:
    return {key: c.counter("ec_batch", key)
            for key in ("stripes", "rmw_delta_runs", "rmw_full_runs")}


async def bounded(coros, limit: int = IO_DEPTH):
    sem = asyncio.Semaphore(limit)

    async def one(co):
        async with sem:
            return await asyncio.wait_for(co, TIMEOUT)
    return await asyncio.gather(*(one(co) for co in coros))


async def scrub_all(c: Cluster, pool_id: int) -> tuple[int, list]:
    """scrub_ec on every PG of the pool, on its primary: the objects
    scrubbed and the inconsistent ones (by PG: where an object lands
    follows its random name)."""
    scrubbed, bad = 0, []
    for o in c.osds:
        for pgid, pg in sorted(o.pgs.items()):
            if pgid.startswith(f"{pool_id}.") and pg.is_primary():
                res = await asyncio.wait_for(c.side.scrub.scrub_ec(pg),
                                             TIMEOUT)
                scrubbed += res.objects_scrubbed
                bad += sorted(res.inconsistent)
    return scrubbed, bad


async def apps_drive(side, k: int, m: int, n_osds: int, pg_num: int,
                     order: int = 16, n_objects: int = 4,
                     n_random: int = 32, n_cached: int = 32,
                     file_bytes: int = 200_000,
                     s3_sizes=(70_000, 131_072, 5)) -> dict:
    rbd = importlib.import_module(f"{side.pkg}.rbd")
    striper = importlib.import_module(f"{side.pkg}.client.striper")
    rgw = importlib.import_module(f"{side.pkg}.rgw")
    S3Client = importlib.import_module(f"{side.pkg}.rgw.client").S3Client
    rng = np.random.default_rng(18)
    c = await Cluster.boot(side, n_osds, osd_config=UNHEDGED)
    gw = None
    out: dict = {}
    try:
        pool = await c.ec_pool("ec", k, m, pg_num=pg_num)
        io = await c.rados.open_ioctx("ec")

        # -- RBD: whole objects, then 4 KiB random writes, 16 in flight
        obj = 1 << order
        size = n_objects * obj
        await rbd.RBD().create(io, "img", size, order=order)
        img = await asyncio.wait_for(rbd.Image.open(io, "img"), TIMEOUT)
        oracle = bytearray(rng.integers(0, 256, size, np.uint8).tobytes())
        await bounded(img.write(i * obj, bytes(oracle[i * obj:(i + 1) * obj]))
                      for i in range(n_objects))
        out["rbd_whole"] = await img.read(0, size) == oracle

        def blocks(n):
            offs = rng.choice(size // BLOCK, n, replace=False) * BLOCK
            return [(int(o), rng.integers(0, 256, BLOCK, np.uint8).tobytes())
                    for o in offs]
        rand = blocks(n_random)
        await bounded(img.write(o, d) for o, d in rand)
        for o, d in rand:
            oracle[o:o + BLOCK] = d
        out["rbd_random"] = await img.read(0, size) == oracle
        await img.close()
        out["counters_rbd"] = counters(c)

        # -- radosstriper: a file over several objects, an overwrite
        lay = striper.Layout(stripe_unit=16384, stripe_count=2,
                             object_size=65536)
        st = striper.RadosStriper(io, lay)
        fdata = bytearray(rng.integers(0, 256, file_bytes, np.uint8)
                          .tobytes())
        await asyncio.wait_for(st.write("file", bytes(fdata)), TIMEOUT)
        patch = rng.integers(0, 256, 777, np.uint8).tobytes()
        await asyncio.wait_for(st.write("file", patch, 30_001), TIMEOUT)
        fdata[30_001:30_001 + len(patch)] = patch
        out["file"] = await st.read("file") == fdata

        # -- RGW over loopback HTTP: PUT/GET and a multipart upload
        store = rgw.RgwStore(io, stripe_unit=1 << 16)
        user = await store.create_user("alice", "Alice", access_key="AK",
                                       secret="SK")
        gw = rgw.Gateway(store)
        s3 = S3Client(await gw.start(), user["access_key"], user["secret"])
        await s3.create_bucket("b")
        bodies = {f"k{i}": rng.integers(0, 256, n, np.uint8).tobytes()
                  for i, n in enumerate(s3_sizes)}
        out["etags"] = {key: await s3.put_object("b", key, body)
                        for key, body in bodies.items()}
        uid = await s3.initiate_multipart("b", "mp")
        parts = [rng.integers(0, 256, n, np.uint8).tobytes()
                 for n in (1 << 17, 1 << 17, 1000)]
        for i, p in enumerate(parts, 1):
            await s3.upload_part("b", "mp", uid, i, p)
        out["etags"]["mp"] = await s3.complete_multipart(
            "b", "mp", uid, [1, 2, 3])
        bodies["mp"] = b"".join(parts)
        out["s3"] = all([await s3.get_object("b", key) == body
                         for key, body in bodies.items()])
        out["counters_apps"] = counters(c)

        # -- RBD through the ObjectCacher: writes ack from the cache
        img = await asyncio.wait_for(
            rbd.Image.open(io, "img", cache=True), TIMEOUT)
        cached = blocks(n_cached)
        await bounded(img.write(o, d) for o, d in cached)
        for o, d in cached:
            oracle[o:o + BLOCK] = d
        await asyncio.wait_for(img.flush(), TIMEOUT)
        out["rbd_cached"] = await img.read(0, size) == oracle
        prefix = img.meta["object_prefix"]
        await img.close()

        # -- kill a shard holder of object 0 that is not its primary
        _, primary, acting = c.target(pool, f"{prefix}.{0:016x}")
        victim = next(o for o in acting if o != primary)
        index = next(i for i, o in enumerate(c.osds) if o.whoami == victim)
        token = await c.kill(victim)
        ro = await asyncio.wait_for(
            rbd.Image.open(io, "img", read_only=True), TIMEOUT)
        out["rbd_degraded"] = await asyncio.wait_for(
            ro.read(0, size), TIMEOUT) == oracle
        await ro.close()
        out["file_degraded"] = await st.read("file") == fdata
        out["s3_degraded"] = all([await s3.get_object("b", key) == body
                                  for key, body in bodies.items()])
        out["marked_down"] = sorted(
            o for o in c.mon.osdmap.osds if not c.mon.osdmap.is_up(o))
        await c.revive(token, index)
        await wait_for(lambda: all(
            o.osdmap.epoch == c.mon.osdmap.epoch for o in c.osds), 10,
            "maps to settle")
        ro = await asyncio.wait_for(
            rbd.Image.open(io, "img", read_only=True), TIMEOUT)
        out["rbd_recovered"] = await ro.read(0, size) == oracle
        await ro.close()
        out["scrub"] = await scrub_all(c, pool)
        out["stored"] = stored_by_content(c, pool)
        out["victim_is_first_down"] = out["marked_down"] == [victim]
        del out["marked_down"]
        return out
    finally:
        if gw is not None:
            await gw.stop()
        await c.stop()
