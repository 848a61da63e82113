"""ObjectCacher: client-side write-back cache (src/osdc/ObjectCacher.cc
role) -- cache-served latency, dirty throttling, flush barriers and
ordering, fence discard, and the librbd/cephfs integrations.

The port's counterpart of ``tests/test_object_cacher.py``: its cases on
``ceph_tpu_torch``, the daemons and librados on ``device="cpu"``.
"""

import asyncio
import time

import pytest

from ceph_tpu_torch.client.object_cacher import CachingIoCtx, ObjectCacher
from ceph_tpu_torch.client.rados import RadosError
from torch_app_cases import OSD, Monitor, Rados, run


class SlowIoCtx:
    """In-memory ioctx stub with configurable write latency and an
    op log (to assert what reached 'the OSDs' and when)."""

    def __init__(self, delay: float = 0.0) -> None:
        self.objects: dict[str, bytearray] = {}
        self.delay = delay
        self.log: list[tuple] = []
        self.fail_writes = False

    async def write(self, oid, data, offset=0):
        if self.delay:
            await asyncio.sleep(self.delay)
        if self.fail_writes:
            raise RadosError("EIO", "injected")
        buf = self.objects.setdefault(oid, bytearray())
        if len(buf) < offset + len(data):
            buf.extend(b"\x00" * (offset + len(data) - len(buf)))
        buf[offset:offset + len(data)] = data
        self.log.append(("write", oid, offset, len(data)))
        return len(data)

    async def read(self, oid, length=None, offset=0, **kw):
        if oid not in self.objects:
            raise RadosError("ENOENT", oid)
        buf = bytes(self.objects[oid])
        self.log.append(("read", oid, offset, length))
        return buf[offset:None if length is None else offset + length]

    async def truncate(self, oid, size):
        buf = self.objects.setdefault(oid, bytearray())
        del buf[size:]
        self.log.append(("truncate", oid, size))

    async def remove(self, oid):
        self.objects.pop(oid, None)
        self.log.append(("remove", oid))


def test_write_acks_from_cache_then_flushes():
    async def main():
        io = SlowIoCtx(delay=0.05)           # 50ms per OSD write
        c = ObjectCacher(io, flush_interval=0.1)
        t0 = time.perf_counter()
        for i in range(20):
            await c.write("obj", i * 100, bytes([i]) * 100)
        buffered_dt = time.perf_counter() - t0
        # 20 writes ack way faster than 20 * 50ms of OSD latency
        assert buffered_dt < 0.05, f"writes not cached: {buffered_dt}"
        assert c.dirty_bytes() == 2000
        await c.flush()
        assert c.dirty_bytes() == 0
        assert bytes(io.objects["obj"]) == b"".join(
            bytes([i]) * 100 for i in range(20))
        # adjacent dirty extents coalesced: far fewer than 20 ops
        assert c.stats["flush_ops"] <= 2
        await c.close()
    run(main())


def test_read_served_from_cache_and_overlay():
    async def main():
        io = SlowIoCtx()
        io.objects["obj"] = bytearray(b"A" * 1000)
        c = ObjectCacher(io)
        assert await c.read("obj", 0, 1000) == b"A" * 1000
        n_reads = len([e for e in io.log if e[0] == "read"])
        # second read: pure cache hit, no OSD op
        assert await c.read("obj", 100, 200) == b"A" * 200
        assert len([e for e in io.log if e[0] == "read"]) == n_reads
        # dirty overlay wins reads immediately, before any flush
        await c.write("obj", 150, b"B" * 50)
        got = await c.read("obj", 100, 200)
        assert got == b"A" * 50 + b"B" * 50 + b"A" * 100
        assert ("write", "obj", 150, 50) not in io.log   # still cached
        await c.close()
    run(main())


def test_dirty_throttle_blocks_writers():
    async def main():
        io = SlowIoCtx(delay=0.01)
        c = ObjectCacher(io, max_dirty=1000, target_dirty=500,
                         flush_interval=0.05)
        for i in range(5):
            await c.write(f"o{i}", 0, b"x" * 400)
        # the cap was enforced: dirty bytes never stay above max
        assert c.dirty_bytes() <= 1000
        await c.close()
        assert all(bytes(io.objects[f"o{i}"]) == b"x" * 400
                   for i in range(5))
    run(main())


def test_flush_failure_keeps_data_dirty():
    """An acked-to-app write must never be dropped because one flush
    attempt failed; it stays dirty and the next barrier retries."""
    async def main():
        io = SlowIoCtx()
        c = ObjectCacher(io)
        await c.write("obj", 0, b"precious")
        io.fail_writes = True
        with pytest.raises(RadosError):
            await c.flush()
        assert c.dirty_bytes() == len(b"precious")
        io.fail_writes = False
        await c.flush()
        assert bytes(io.objects["obj"]) == b"precious"
        await c.close()
    run(main())


def test_concurrent_write_during_flush_not_lost():
    """A write racing an in-flight flush of the same range must win
    reads and survive to the next flush (never mutate a TX buffer)."""
    async def main():
        io = SlowIoCtx(delay=0.05)
        c = ObjectCacher(io)
        await c.write("obj", 0, b"OLD" * 10)
        fl = asyncio.ensure_future(c.flush())
        await asyncio.sleep(0.01)             # flush in flight (TX)
        await c.write("obj", 0, b"NEW" * 10)  # racing write
        await fl
        assert await c.read("obj", 0, 30) == b"NEW" * 10
        await c.flush()
        assert bytes(io.objects["obj"])[:30] == b"NEW" * 10
        await c.close()
    run(main())


def test_fence_discard_drops_dirty():
    async def main():
        io = SlowIoCtx()
        c = ObjectCacher(io)
        await c.write("obj", 0, b"must die")
        c.discard_all()
        await c.flush()
        assert "obj" not in io.objects        # never reached the OSDs
        await c.close()
    run(main())


def test_caching_ioctx_truncate_ordering():
    """Buffered writes land BEFORE a truncate; a later flush must not
    resurrect truncated bytes."""
    async def main():
        io = SlowIoCtx()
        cio = CachingIoCtx(io)
        await cio.write("obj", b"0123456789", offset=0)
        await cio.truncate("obj", 4)
        await cio.cacher.flush()
        assert bytes(io.objects["obj"]) == b"0123"
        await cio.cacher.close()
    run(main())


# -- integrations -------------------------------------------------------------

async def mk_cluster():
    mon = Monitor(rank=0, config={"mon_osd_min_down_reporters": 1})
    addr = await mon.start()
    mon.peer_addrs = [addr]
    osds = []
    for i in range(2):
        o = OSD(host=f"h{i}", whoami=i)
        await o.start(addr)
        osds.append(o)
    r = Rados(addr, name="client.cache")
    await r.connect()
    await r.mon_command("osd pool create",
                        {"name": "p", "pg_num": 4, "size": 2})
    return mon, addr, osds, r


def test_rbd_cached_image_io_and_snap_barrier():
    from ceph_tpu_torch.rbd import RBD, Image

    async def main():
        mon, addr, osds, r = await mk_cluster()
        iop = await r.open_ioctx("p")
        await RBD().create(iop, "img", size=8 << 20)
        img = await Image.open(iop, "img", cache=True)
        assert img.cacher is not None
        await img.write(0, b"cached write " * 100)
        assert img.cacher.dirty_bytes() > 0      # buffered, not flushed
        # read-your-writes from cache
        assert (await img.read(0, 13)) == b"cached write "
        # snapshot barrier: dirty data lands BEFORE the snap freezes
        await img.create_snap("s1")
        assert img.cacher.dirty_bytes() == 0
        await img.write(0, b"post-snap data")
        await img.flush()
        snap_view = await Image.open(iop, "img", snapshot="s1")
        assert (await snap_view.read(0, 13)) == b"cached write "
        assert (await img.read(0, 14)) == b"post-snap data"
        await snap_view.close()
        await img.close()
        await r.shutdown()
        for o in osds:
            await o.stop()
        await mon.stop()
    run(main())


def test_cephfs_cached_file_io():
    """The CephFS client's cached data path without its MDS (not ported
    yet): file data striped by a ``RadosStriper`` over the shared
    ``CachingIoCtx``, writes acked from the cache, the close's flush as
    the barrier, and a second, uncached handle reading what landed."""
    from ceph_tpu_torch.client.striper import Layout, RadosStriper

    async def main():
        mon, addr, osds, r = await mk_cluster()
        io = await r.open_ioctx("p")
        cache = CachingIoCtx(io)
        layout = Layout(stripe_unit=1 << 16, stripe_count=1,
                        object_size=1 << 22)
        f = RadosStriper(cache, layout)
        await f.write("10000000000.file", b"write-back data", 0)
        assert cache.cacher.dirty_bytes() > 0
        assert await f.read("10000000000.file", 15, 0) == b"write-back data"
        await cache.flush()                  # fsync barrier flushes
        assert cache.cacher.dirty_bytes() == 0
        # a second (uncached) handle sees the data: it really landed
        r2 = await Rados(addr, name="client.fs2").connect()
        io2 = await r2.open_ioctx("p")
        assert await RadosStriper(io2, layout).read(
            "10000000000.file", 15, 0) == b"write-back data"
        await r2.shutdown()
        await cache.cacher.close()
        await r.shutdown()
        for o in osds:
            await o.stop()
        await mon.stop()
    run(main())
