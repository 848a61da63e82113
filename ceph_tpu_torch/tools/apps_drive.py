"""Ceph's client applications over one cluster: RBD, radosstriper, RGW.

``AppsDrive`` is a ``ClusterDrive`` (``tools/ec_osd_bench.py``: a monitor
and ``n_osds`` OSDs, one a host, MemStore, through ``SimCluster`` on one
device; its EC pool, here ``ec83``, on the ``cuda`` plugin, RS k=8,m=3 by
default at the pool's default 4 KiB stripe unit; its kill, revive and
scrub) with a replicated pool ``rbd`` beside it (the reference refuses
snapshots on EC pools).  It drives what users run over them, one step a
method:

- an RBD image on the EC pool at Ceph's defaults (order 22, 16 I/Os in
  flight): written whole in 4 MiB writes and read back, 256 sequential
  4 KiB writes in ``rbd bench``'s shape, 256 random 4 KiB writes, 256 more
  through the ``ObjectCacher`` with a flush, a read of the whole image
  while one shard holder of its object 0 is down, recovery, ``scrub_ec``,
  and an encrypted image with a wrong passphrase refused;
- RBD's features on the replicated pool: snapshots, clone, copyup,
  flatten, rollback, resize, discard, export, the object map and
  ``fast_diff``, an exclusive lock broken by a second client whose
  blocklist refuses the deposed holder's next write, a live migration,
  and snapshot- and journal-mode mirroring to a second cluster;
- radosstriper on the EC pool at ``Layout()``'s defaults: a striped file
  written, read, overwritten, truncated and removed, two handles writing
  one file at once, and ``SimpleRADOSStriper`` taking over a lapsed lock;
- RGW on the EC pool (4 MiB stripes) through ``Gateway`` and
  ``S3Client`` over loopback HTTP: PUT/GET, multipart, list, HEAD,
  DELETE, a versioned bucket, Swift, and GETs while one OSD is down.

A host bytearray is the oracle of every read; a mismatch is recorded in
``report["mismatches"]`` and a failed I/O in ``report["failed_ops"]``.
Each step records its host-clock seconds and rates in ``report``.  The
daemons run on the card unless ``device="cpu"``.
"""

from __future__ import annotations

import asyncio
import json
import time

import numpy as np

from .ec_osd_bench import TIMEOUT, ClusterDrive, poll

GiB = float(1 << 30)
MiB = 1 << 20
SEED = 18
IO_SIZE = 4096          # rbd bench's io-size
MIRROR_OSDS = 3         # the mirror's second cluster
LOCK_HOLDER = "client.holder"


class AppsDrive(ClusterDrive):
    """The client applications over one ``ClusterDrive`` cluster, one step
    a method.  ``cluster`` takes ``ClusterDrive``'s arguments (12 OSDs,
    RS k=8,m=3, pg_num 32, 16 I/Os in flight by default); the defaults of
    the sizes are the card's.  The cuts, for the run's time: the image,
    128 MiB (a VM disk is typically 10 GiB or more), the 4 KiB rounds, 64
    writes each (``rbd bench`` writes 1 GiB by default), the encrypted and
    the features' images, 32 MiB each, the striper's file, 32 MiB, RGW's
    objects, 8 of 8 MiB, and its multipart upload, 32 MiB."""

    pool = "ec83"

    def __init__(self, *, rep_pg_num: int = 32, image_bytes: int = 128 * MiB,
                 order: int = 22, bench_ios: int = 64,
                 crypto_bytes: int = 32 * MiB, feature_bytes: int = 32 * MiB,
                 file_bytes: int = 32 * MiB, s3_objects: int = 8,
                 s3_bytes: int = 8 * MiB, multipart_bytes: int = 32 * MiB,
                 part_bytes: int = 8 * MiB, s3_stripe: int = 4 * MiB,
                 **cluster) -> None:
        super().__init__(n_objects=0, **cluster)
        self.rep_pg_num = rep_pg_num
        self.image_bytes, self.order = image_bytes, order
        self.bench_ios = bench_ios
        self.crypto_bytes, self.feature_bytes = crypto_bytes, feature_bytes
        self.file_bytes = file_bytes
        self.s3_objects, self.s3_bytes = s3_objects, s3_bytes
        self.multipart_bytes, self.part_bytes = multipart_bytes, part_bytes
        self.s3_stripe = s3_stripe
        self.rng = np.random.default_rng(SEED)
        self.rep = None                   # ioctx of the replicated pool
        self.image_prefix = None          # rbd_data.<id> of the EC image
        self.oracle = bytearray()         # the EC image's bytes
        self._gw = None
        self._s3 = None
        self.s3_src: dict[str, bytes] = {}
        self._clients: list = []          # the drive's other handles
        self.sites: list = []             # the mirror's second cluster

    @property
    def victim_oid(self) -> str:
        """The image's object 0."""
        return f"{self.image_prefix}.{0:016x}"

    async def boot(self) -> None:
        """``ClusterDrive``'s boot, then the replicated pool ``rbd``."""
        t0 = time.perf_counter()
        await super().boot()
        await self.rados.pool_create("rbd", pg_num=self.rep_pg_num, size=3)
        self.rep = await self.rados.open_ioctx("rbd")
        self.report["boot_s"] = time.perf_counter() - t0

    async def _client(self, name: str, cluster=None):
        from ..client.rados import Rados
        c = cluster or self.cluster
        r = await Rados(c.addr, name=name, device=c.mon.device).connect()
        self._clients.append(r)
        return r

    async def stop(self) -> None:
        if self._gw is not None:
            await self._gw.stop()
        for r in self._clients:
            await r.shutdown()
        for c in self.sites:
            await c.stop()
        await super().stop()

    # -- 12a: an RBD image on the EC pool -------------------------------------
    async def rbd_create(self) -> None:
        from ..rbd import RBD
        await RBD().create(self.io, "vm", self.image_bytes, order=self.order)
        self.oracle = bytearray(self.image_bytes)

    async def _open(self, name: str = "vm", **kw):
        from ..rbd import Image
        return await asyncio.wait_for(Image.open(self.io, name, **kw),
                                      TIMEOUT)

    async def _read_image(self, img, label: str) -> None:
        """The whole image in object-size reads, ``concurrency``
        in flight, against the oracle."""
        obj = 1 << self.order
        got = {}

        async def one(off):
            got[off] = await img.read(off, obj)
        t0 = time.perf_counter()
        await self._ops(one(off) for off in range(0, self.image_bytes, obj))
        self._rate(label, self.image_bytes, time.perf_counter() - t0)
        self._check(label, all(got.get(off) == self.oracle[off:off + obj]
                               for off in range(0, self.image_bytes, obj)))

    async def rbd_write_read(self) -> None:
        """The image written whole in object-size writes, then read."""
        img = await self._open()
        self.image_prefix = img.meta["object_prefix"]
        obj = 1 << self.order
        self.oracle[:] = self.rng.integers(0, 256, self.image_bytes,
                                           np.uint8).tobytes()
        t0 = time.perf_counter()
        await self._ops(img.write(off, bytes(self.oracle[off:off + obj]))
                        for off in range(0, self.image_bytes, obj))
        self._rate("rbd_write", self.image_bytes, time.perf_counter() - t0)
        await self._read_image(img, "rbd_read")
        await img.close()

    async def rbd_bench_seq(self) -> None:
        """``rbd bench``'s shape: ``bench_ios`` sequential writes of
        ``IO_SIZE`` one after another, its repeating buffer."""
        img = await self._open()
        bs = IO_SIZE
        buf = (bytes(range(256)) * (bs // 256 + 1))[:bs]
        slots = self.image_bytes // bs
        lat = []
        t0 = time.perf_counter()
        for i in range(self.bench_ios):
            off = (i % slots) * bs
            lat += await self._ops([img.write(off, buf)], 1)
            self.oracle[off:off + bs] = buf
        self._iops("rbd_seq_4k", lat, time.perf_counter() - t0)
        await img.close()

    def _blocks(self, n: int) -> list[tuple[int, bytes]]:
        bs = IO_SIZE
        offs = self.rng.choice(self.image_bytes // bs, n, replace=False) * bs
        return [(int(o), self.rng.integers(0, 256, bs, np.uint8).tobytes())
                for o in offs]

    async def rbd_random(self) -> None:
        """``bench_ios`` random aligned writes, ``concurrency`` in
        flight."""
        img = await self._open()
        blocks = self._blocks(self.bench_ios)
        t0 = time.perf_counter()
        lat = await self._ops(img.write(o, d) for o, d in blocks)
        self._iops("rbd_random_4k", lat, time.perf_counter() - t0)
        for o, d in blocks:
            self.oracle[o:o + len(d)] = d
        await img.close()

    async def rbd_cached(self) -> None:
        """The same through the ObjectCacher: writes ack from the cache,
        ``flush`` lands them; then each block read back."""
        img = await self._open(cache=True)
        blocks = self._blocks(self.bench_ios)
        t0 = time.perf_counter()
        lat = await self._ops(img.write(o, d) for o, d in blocks)
        self._iops("rbd_cached_4k", lat, time.perf_counter() - t0)
        for o, d in blocks:
            self.oracle[o:o + len(d)] = d
        t0 = time.perf_counter()
        await asyncio.wait_for(img.flush(), TIMEOUT)
        self.report["rbd_flush_s"] = time.perf_counter() - t0
        self.report["rbd_cache_stats"] = dict(img.cacher.stats)
        got = {}

        async def one(o, n):
            got[o] = await img.read(o, n)
        await self._ops(one(o, len(d)) for o, d in blocks)
        self._check("rbd_cached_read", all(got.get(o) == d
                                           for o, d in blocks))
        await img.close()

    async def rbd_degraded_read(self) -> None:
        img = await self._open(read_only=True)
        await self._read_image(img, "rbd_degraded_read")
        await img.close()

    async def rbd_crypto(self) -> None:
        """An encrypted image on the EC pool: formatted, written and read
        back whole; a wrong passphrase is refused."""
        from ..rbd import RBD, RbdError
        from ..rbd.crypto import WrongPassphrase
        n = self.crypto_bytes
        await RBD().create(self.io, "vault", n, order=self.order)
        img = await self._open("vault")
        await img.encryption_format("s3cr3t")
        data = self.rng.integers(0, 256, n, np.uint8).tobytes()
        obj = 1 << self.order
        t0 = time.perf_counter()
        await self._ops(img.write(off, data[off:off + obj])
                        for off in range(0, n, obj))
        self._rate("crypto_write", n, time.perf_counter() - t0)
        await img.close()
        img = await self._open("vault", passphrase="s3cr3t")
        t0 = time.perf_counter()
        self._check("crypto_read", await img.read(0, n) == data)
        self._rate("crypto_read", n, time.perf_counter() - t0)
        await img.close()
        # Image.open raises RbdError EPERM from the WrongPassphrase
        try:
            img = await self._open("vault", passphrase="wrong")
        except RbdError as e:
            self.report["crypto_wrong_passphrase_refused"] = isinstance(
                e.__cause__, WrongPassphrase)
        else:
            await img.close()
        self._check("crypto_wrong_passphrase_refused",
                    self.report.get("crypto_wrong_passphrase_refused"))

    # -- 12b: RBD features on the replicated pool -----------------------------
    async def rbd_features(self) -> None:
        """Snapshots, protect, clone, copyup, flatten, rollback, resize,
        discard, export, the object map and ``fast_diff`` on a
        ``feature_bytes`` image of the replicated pool."""
        from ..rbd import RBD, Image
        from ..rbd.features import OBJ_EXISTS, disk_usage, fast_diff
        t0 = time.perf_counter()
        io, rbd, order = self.rep, RBD(), self.order
        obj = 1 << order
        n = self.feature_bytes
        await rbd.create(io, "base", n, order=order, features=[
            "layering", "exclusive-lock", "object-map"])
        base = await Image.open(io, "base")
        want = bytearray(self.rng.integers(0, 256, n, np.uint8).tobytes())
        await self._ops(base.write(off, bytes(want[off:off + obj]))
                        for off in range(0, n, obj))
        states = await base.object_map.states()
        self._check("object_map", all(s == OBJ_EXISTS
                                      for s in states[:n // obj]))
        du = await disk_usage(base)
        self._check("disk_usage", du["used"] == n)
        await base.create_snap("s1")
        frozen = bytes(want)
        await base.protect_snap("s1")
        await rbd.clone(io, "base", "s1", io, "child")
        # the parent moves on after the snap; the child must not see it
        patch = self.rng.integers(0, 256, 3 * obj // 2, np.uint8).tobytes()
        await base.write(obj // 4, patch)
        want[obj // 4:obj // 4 + len(patch)] = patch
        self._check("fast_diff", await fast_diff(base, "s1") == [0, 1])
        child = await Image.open(io, "child")
        cwant = bytearray(frozen)
        mine = self.rng.integers(0, 256, 4096, np.uint8).tobytes()
        await child.write(obj + 100, mine)               # copyup
        cwant[obj + 100:obj + 100 + 4096] = mine
        self._check("clone_read", await child.read(0, n) == cwant)
        await child.flatten()
        self._check("flatten", child.meta["parent"] is None
                    and await child.read(0, n) == cwant)
        await child.close()
        await base.unprotect_snap("s1")
        # rollback restores the snap's bytes to the head
        await base.rollback_snap("s1")
        self._check("rollback", await base.read(0, n) == frozen)
        await base.resize(n // 2)
        await base.resize(n)
        tail = await base.read(n // 2, obj)
        self._check("resize", tail == b"\0" * obj)
        await base.discard(0, 4096)
        got = bytearray()
        async for _, piece in base.export():
            got += piece
        ewant = bytearray(frozen)
        ewant[n // 2:] = b"\0" * (n - n // 2)
        ewant[:4096] = b"\0" * 4096
        self._check("export", got == ewant)
        await base.close()
        self.report["features_s"] = time.perf_counter() - t0

    async def rbd_lock_takeover(self) -> None:
        """A holder's exclusive lock broken by a second client
        (``break_lock``): the new owner writes, the deposed holder's next
        write bounces at the OSDs (blocklisted) and the owner's bytes
        stay."""
        from ..rbd import RBD, Image, RbdError
        io = self.rep
        await RBD().create(io, "locked", 1 << self.order, order=self.order,
                           features=["layering", "exclusive-lock"])
        holder = await (await self._client(LOCK_HOLDER)).open_ioctx("rbd")
        other = await (await self._client("client.other")).open_ioctx("rbd")
        old = await Image.open(holder, "locked")
        await old.write(0, b"old-owner")
        await Image.break_lock(other, "locked")
        new = await Image.open(other, "locked")
        await new.write(0, b"new-owner")
        await poll(lambda: all(o.osdmap.is_blocklisted(LOCK_HOLDER)
                               for o in self.cluster.osds
                               if not o.is_stopped()),
                   TIMEOUT, "the blocklist to reach the OSDs")
        try:
            await old.write(0, b"stale-own")
        except RbdError as e:
            self.report["lock_fence"] = str(e)
        self._check("lock_fence", "EBLOCKLISTED"
                    in self.report.get("lock_fence", ""))
        self._check("lock_owner_bytes", await new.read(0, 9) == b"new-owner")
        await new.close()
        await old.close()

    async def rbd_migration(self) -> None:
        """prepare, execute, commit: the image moves pools with a write
        served by the destination before the copy."""
        from ..rbd import RBD, Image
        from ..rbd.migration import (migration_commit, migration_execute,
                                     migration_prepare)
        await self.rados.pool_create("rbd-new", pg_num=8, size=3)
        dst = await self.rados.open_ioctx("rbd-new")
        obj = 1 << self.order
        n = 4 * obj
        await RBD().create(self.rep, "mig", n, order=self.order)
        img = await Image.open(self.rep, "mig")
        want = bytearray(self.rng.integers(0, 256, n, np.uint8).tobytes())
        await self._ops(img.write(off, bytes(want[off:off + obj]))
                        for off in range(0, n, obj))
        await img.close()
        t0 = time.perf_counter()
        await migration_prepare(self.rep, "mig", dst, "mig")
        d = await Image.open(dst, "mig")
        await d.write(100, b"LIVE-WRITE")
        want[100:110] = b"LIVE-WRITE"
        await d.close()
        self.report["migration_bytes"] = await migration_execute(dst, "mig")
        await migration_commit(dst, "mig")
        self.report["migration_s"] = time.perf_counter() - t0
        d = await Image.open(dst, "mig")
        self._check("migration", await d.read(0, n) == want
                    and "mig" not in await RBD().list(self.rep))
        await d.close()

    async def rbd_mirror(self) -> None:
        """One image mirrored to a second cluster of ``MIRROR_OSDS`` OSDs
        on the same device, in snapshot mode (an initial and an
        incremental sync) and in journal mode (bootstrap, replay)."""
        from ..loadgen.cluster import SimCluster
        from ..rbd import RBD, Image
        from ..rbd.mirror import (journal_bootstrap, journal_replay_once,
                                  mirror_enable, mirror_sync)
        t0 = time.perf_counter()
        site_b = await SimCluster.create(MIRROR_OSDS,
                                         device=self.cluster.mon.device)
        self.sites.append(site_b)
        rb = await self._client("client.siteB", site_b)
        await rb.pool_create("rbd", pg_num=8, size=3)
        ib = await rb.open_ioctx("rbd")
        obj = 1 << self.order
        n = 4 * obj
        # snapshot mode
        await RBD().create(self.rep, "snapm", n, order=self.order)
        img = await Image.open(self.rep, "snapm")
        want = bytearray(self.rng.integers(0, 256, n, np.uint8).tobytes())
        await self._ops(img.write(off, bytes(want[off:off + obj]))
                        for off in range(0, n, obj))
        await img.close()
        first = await mirror_sync(self.rep, ib, "snapm")
        img = await Image.open(self.rep, "snapm")
        await img.write(2 * obj, b"DATA-BLOCK")
        want[2 * obj:2 * obj + 10] = b"DATA-BLOCK"
        await img.close()
        second = await mirror_sync(self.rep, ib, "snapm")
        self.report["mirror_snapshot_objects"] = [first["objects_copied"],
                                                  second["objects_copied"]]
        dimg = await Image.open(ib, "snapm", read_only=True)
        self._check("mirror_snapshot", await dimg.read(0, n) == want
                    and second["objects_copied"] == 1)
        await dimg.close()
        # journal mode
        await RBD().create(self.rep, "jrnl", n, order=self.order, features=[
            "layering", "exclusive-lock", "object-map", "journaling"])
        img = await Image.open(self.rep, "jrnl")
        jwant = bytearray(n)
        head = self.rng.integers(0, 256, obj, np.uint8).tobytes()
        await img.write(0, head)
        jwant[:obj] = head
        await mirror_enable(self.rep, "jrnl")
        await journal_bootstrap(self.rep, ib, "jrnl")
        more = self.rng.integers(0, 256, obj, np.uint8).tobytes()
        await img.write(obj, more)
        jwant[obj:2 * obj] = more
        await img.discard(0, 4096)
        jwant[:4096] = b"\0" * 4096
        replayed = await journal_replay_once(self.rep, ib, "jrnl",
                                             limit=100)
        self.report["mirror_journal_events"] = replayed
        await img.close()
        dimg = await Image.open(ib, "jrnl", read_only=True)
        self._check("mirror_journal", replayed >= 2
                    and await dimg.read(0, n) == jwant)
        await dimg.close()
        self.report["mirror_s"] = time.perf_counter() - t0

    # -- 12c: radosstriper on the EC pool -------------------------------------
    async def striper(self) -> None:
        """A ``file_bytes`` striped file at ``Layout()``'s defaults:
        write, read, a sub-object overwrite, truncate, remove; then two
        handles of two clients writing disjoint halves of one file at
        once."""
        from ..client.radosstriper import RadosStriperCtx
        from ..client.striper import Layout
        st = RadosStriperCtx(self.io, Layout())
        n = self.file_bytes
        data = bytearray(self.rng.integers(0, 256, n, np.uint8).tobytes())
        t0 = time.perf_counter()
        await asyncio.wait_for(st.write("file", bytes(data)), TIMEOUT)
        self._rate("striper_write", n, time.perf_counter() - t0)
        t0 = time.perf_counter()
        got = await asyncio.wait_for(st.read("file"), TIMEOUT)
        self._rate("striper_read", n, time.perf_counter() - t0)
        self._check("striper_read", got == data)
        patch = self.rng.integers(0, 256, 10_000, np.uint8).tobytes()
        at = n // 3 + 123
        await st.write("file", patch, at)
        data[at:at + len(patch)] = patch
        self._check("striper_overwrite",
                    await st.read("file", 3 * len(patch), at - len(patch))
                    == data[at - len(patch):at + 2 * len(patch)])
        cut = n // 2 + 4097
        await st.truncate("file", cut)
        self._check("striper_truncate", (await st.stat("file"))["size"] == cut
                    and await st.read("file") == data[:cut])
        await st.remove("file")
        self._check("striper_remove", (await st.stat("file"))["size"] == 0)
        # two clients, one file, disjoint halves at once
        io2 = await (await self._client("client.striper2")).open_ioctx(
            "ec83")
        a, b = st, RadosStriperCtx(io2, Layout())
        half = n // 4
        pa = self.rng.integers(0, 256, half, np.uint8).tobytes()
        pb = self.rng.integers(0, 256, half, np.uint8).tobytes()
        t0 = time.perf_counter()
        await asyncio.wait_for(asyncio.gather(
            a.write("shared", pa, 0), b.write("shared", pb, half)), TIMEOUT)
        self._rate("striper_two_clients_write", 2 * half,
                   time.perf_counter() - t0)
        self._check("striper_two_clients",
                    await a.read("shared") == pa + pb
                    and (await b.stat("shared"))["size"] == 2 * half)

    async def striper_takeover(self) -> None:
        """``SimpleRADOSStriper``: a holder that has gone (its lock
        broken) is blocklisted by the next opener, whose writes stand;
        the old handle's late write bounces."""
        from ..client.radosstriper import SRS_LOCK, SimpleRADOSStriper
        gone = await (await self._client("client.gone")).open_ioctx("ec83")
        new_io = await (await self._client("client.heir")).open_ioctx(
            "ec83")
        old = await SimpleRADOSStriper(gone, "db").open()
        await old.write(b"mine" * 1000, 0)
        info = json.loads(await new_io.exec(
            old._first(), "lock", "get_info",
            json.dumps({"name": SRS_LOCK}).encode()))
        for lk in info["lockers"]:
            await new_io.exec(old._first(), "lock", "break_lock", json.dumps(
                {"name": SRS_LOCK, "locker": lk["entity"],
                 "cookie": lk["cookie"]}).encode())
        new = await SimpleRADOSStriper(new_io, "db").open()
        await poll(lambda: all(o.osdmap.is_blocklisted("client.gone")
                               for o in self.cluster.osds
                               if not o.is_stopped()),
                   TIMEOUT, "the blocklist to reach the OSDs")
        try:
            await old.write(b"late dirty write", 100)
        except Exception as e:                  # either fence will do
            self.report["striper_fence"] = repr(e)[:200]
        self._check("striper_fence", "BLOCKLISTED"
                    in self.report.get("striper_fence", ""))
        await new.write(b"owned by new", 0)
        self._check("striper_takeover", await new.read(12, 0)
                    == b"owned by new")
        await new.close()
        await old.close()                 # its writes bounce: released

    # -- 12d: RGW on the EC pool ----------------------------------------------
    async def rgw_start(self) -> None:
        from ..rgw import Gateway, RgwStore
        from ..rgw.client import S3Client
        store = RgwStore(self.io, stripe_unit=self.s3_stripe)
        user = await store.create_user("alice", "Alice")
        self._gw = Gateway(store)
        self._user = user
        self._gaddr = await self._gw.start()
        self._s3 = S3Client(self._gaddr, user["access_key"], user["secret"])

    async def rgw_put_get(self) -> None:
        """``s3_objects`` PUTs and GETs of ``s3_bytes``, ``concurrency`` in
        flight; a multipart upload; list and HEAD."""
        import hashlib
        s3 = self._s3
        await s3.create_bucket("bkt")
        self.s3_src = {f"obj-{i:03d}": self.rng.integers(
            0, 256, self.s3_bytes, np.uint8).tobytes()
            for i in range(self.s3_objects)}
        etags = {}

        async def put(key, body):
            etags[key] = await s3.put_object("bkt", key, body)
        t0 = time.perf_counter()
        await self._ops(put(k, b) for k, b in self.s3_src.items())
        self._rate("s3_put", self.s3_objects * self.s3_bytes,
                   time.perf_counter() - t0)
        self._check("s3_etags", all(etags.get(k) == hashlib.md5(b)
                                    .hexdigest()
                                    for k, b in self.s3_src.items()))
        await self._get_all("s3_get")
        # multipart: part_bytes parts
        parts = [self.rng.integers(0, 256, self.part_bytes, np.uint8)
                 .tobytes() for _ in range(self.multipart_bytes
                                           // self.part_bytes)]
        t0 = time.perf_counter()
        uid = await s3.initiate_multipart("bkt", "big")
        await self._ops(s3.upload_part("bkt", "big", uid, i, p)
                        for i, p in enumerate(parts, 1))
        etag = await s3.complete_multipart("bkt", "big", uid,
                                           list(range(1, len(parts) + 1)))
        self._rate("s3_multipart", self.multipart_bytes,
                   time.perf_counter() - t0)
        self._check("s3_multipart_etag", etag.endswith(f"-{len(parts)}"))
        self.s3_src["big"] = b"".join(parts)
        t0 = time.perf_counter()
        self._check("s3_multipart_get",
                    await s3.get_object("bkt", "big") == self.s3_src["big"])
        self._rate("s3_multipart_get", self.multipart_bytes,
                   time.perf_counter() - t0)
        listed = await s3.list_objects("bkt")
        self._check("s3_list", listed["keys"] == sorted(self.s3_src))
        head = await s3.head_object("bkt", "obj-000")
        self._check("s3_head", int(head["content-length"]) == self.s3_bytes)

    async def _get_all(self, label: str) -> None:
        got = {}

        async def get(key):
            got[key] = await self._s3.get_object("bkt", key)
        t0 = time.perf_counter()
        await self._ops(get(k) for k in self.s3_src)
        self._rate(label, sum(map(len, self.s3_src.values())),
                   time.perf_counter() - t0)
        self._check(label, all(got.get(k) == b for k, b in
                               self.s3_src.items()))

    async def rgw_degraded_get(self) -> None:
        await self._get_all("s3_degraded_get")

    async def rgw_versioning(self) -> None:
        """A versioned bucket: two versions of a key and a delete
        marker; both versions stay readable by id."""
        from ..rgw.client import S3Error
        s3 = self._s3
        await s3.create_bucket("vers")
        await s3.put_bucket_versioning("vers", "Enabled")
        vids = []
        for body in (b"version one", b"version two"):
            _, h, _ = await s3.request("PUT", "/vers/k", body=body)
            vids.append(h["x-amz-version-id"])
        marker = await s3.delete_object("vers", "k")
        try:
            await s3.get_object("vers", "k")
            hidden = False
        except S3Error as e:
            hidden = e.code == "NoSuchKey"
        versions = await s3.list_object_versions("vers")
        self._check("s3_versioning", hidden and marker["delete_marker"]
                    and len(set(vids)) == 2 and len(versions) == 3
                    and await s3.get_object_version("vers", "k", vids[0])
                    == b"version one"
                    and await s3.get_object_version("vers", "k", vids[1])
                    == b"version two")

    async def rgw_swift(self) -> None:
        """One Swift PUT and GET through TempAuth."""
        user = self._user
        st, h, _ = await http_request(self._gaddr, "GET", "/auth/v1.0", {
            "x-auth-user": f"{user['access_key']}:u",
            "x-auth-key": user["secret"]})
        tok = {"x-auth-token": h.get("x-auth-token", "")}
        base = h.get("x-storage-url", "")
        body = self.rng.integers(0, 256, 1 * MiB, np.uint8).tobytes()
        put_st, _, _ = await http_request(self._gaddr, "PUT",
                                          f"{base}/swift", tok)
        obj_st, _, _ = await http_request(self._gaddr, "PUT",
                                          f"{base}/swift/blob", tok, body)
        get_st, _, got = await http_request(self._gaddr, "GET",
                                            f"{base}/swift/blob", tok)
        self._check("swift", (st, put_st, obj_st, get_st) ==
                    (200, 201, 201, 200) and got == body)

    async def rgw_delete(self) -> None:
        """DELETE every object of the bucket, then the bucket."""
        from ..rgw.client import S3Error
        s3 = self._s3
        await self._ops(s3.delete_object("bkt", k) for k in self.s3_src)
        self._check("s3_delete", (await s3.list_objects("bkt"))["keys"]
                    == [])
        try:
            await s3.get_object("bkt", "obj-000")
            gone = False
        except S3Error as e:
            gone = e.code == "NoSuchKey"
        self._check("s3_deleted_get", gone)
        await s3.delete_bucket("bkt")


async def http_request(addr, method: str, path: str, headers=None,
                       body: bytes = b""):
    """One HTTP/1.1 exchange: (status, headers, body)."""
    reader, writer = await asyncio.open_connection(*addr)
    try:
        hdrs = {"content-length": str(len(body)), **(headers or {})}
        lines = [f"{method} {path} HTTP/1.1", "host: x"]
        lines += [f"{k}: {v}" for k, v in hdrs.items()]
        writer.write(("\r\n".join(lines) + "\r\n\r\n").encode() + body)
        await writer.drain()
        status = int((await reader.readline()).split()[1])
        rhdrs = {}
        while True:
            ln = await reader.readline()
            if ln in (b"\r\n", b"\n", b""):
                break
            k, _, v = ln.decode().partition(":")
            rhdrs[k.strip().lower()] = v.strip()
        n = int(rhdrs.get("content-length", "0") or "0")
        return status, rhdrs, (await reader.readexactly(n) if n else b"")
    finally:
        writer.close()
