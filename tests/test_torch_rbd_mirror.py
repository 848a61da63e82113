"""rbd-mirror: snapshot-based replication between TWO live clusters
(src/tools/rbd_mirror snapshot mode).

The port's counterpart of ``tests/test_rbd_mirror.py``: its cases on
``ceph_tpu_torch``, the daemons and librados on ``device="cpu"``.
"""

import asyncio

import pytest

from torch_app_cases import Rados
from ceph_tpu_torch.rbd import RBD, Image
from ceph_tpu_torch.rbd.mirror import (
    MirrorDaemon, mirror_disable, mirror_enable, mirror_status,
    mirror_sync,
)

from torch_app_cases import make_cluster, run, teardown

ORDER = 14


async def two_clusters():
    mon_a, osds_a = await make_cluster(3)
    mon_b, osds_b = await make_cluster(3)
    ra = await Rados(mon_a.msgr.addr, name="client.siteA").connect()
    rb = await Rados(mon_b.msgr.addr, name="client.siteB").connect()
    await ra.pool_create("rbd", pg_num=4)
    await rb.pool_create("rbd", pg_num=4)
    ia = await ra.open_ioctx("rbd")
    ib = await rb.open_ioctx("rbd")
    return (mon_a, osds_a, ra, ia), (mon_b, osds_b, rb, ib)


def test_mirror_initial_and_incremental_sync():
    async def main():
        site_a, site_b = await two_clusters()
        mon_a, osds_a, ra, ia = site_a
        mon_b, osds_b, rb, ib = site_b
        rbd = RBD()
        try:
            await rbd.create(ia, "vm-disk", 4 * (1 << ORDER),
                             order=ORDER)
            img = await Image.open(ia, "vm-disk")
            await img.write(0, b"boot-sector")
            await img.write(2 * (1 << ORDER), b"data-block")
            await img.close()
            # initial sync materializes the image on the secondary
            out = await mirror_sync(ia, ib, "vm-disk")
            assert out["snap"] == ".mirror.1"
            assert out["objects_copied"] > 0
            assert "vm-disk" in await rbd.list(ib)
            dimg = await Image.open(ib, "vm-disk", read_only=True)
            assert await dimg.read(0, 11) == b"boot-sector"
            assert await dimg.read(2 * (1 << ORDER), 10) == b"data-block"
            await dimg.close()
            # incremental: touch ONE object; only it is copied
            img = await Image.open(ia, "vm-disk")
            await img.write(2 * (1 << ORDER), b"DATA-BLOCK")
            await img.close()
            out = await mirror_sync(ia, ib, "vm-disk")
            assert out["snap"] == ".mirror.2"
            assert out["objects_copied"] == 1
            dimg = await Image.open(ib, "vm-disk", read_only=True)
            assert await dimg.read(0, 11) == b"boot-sector"
            assert await dimg.read(2 * (1 << ORDER), 10) == b"DATA-BLOCK"
            # the secondary holds point-in-time mirror snapshots
            assert [s["name"] for s in dimg.list_snaps()] == \
                [".mirror.1", ".mirror.2"]
            await dimg.close()
            # reading the secondary AT mirror.1 shows the old content
            old = await Image.open(ib, "vm-disk", snapshot=".mirror.1")
            assert await old.read(2 * (1 << ORDER), 10) == b"data-block"
            await old.close()
            st = await mirror_status(ia, "vm-disk")
            assert st["last_sync"] == ".mirror.2"
        finally:
            await teardown(mon_a, osds_a, ra)
            await teardown(mon_b, osds_b, rb)
    run(main())


def test_failed_sync_orphan_does_not_lose_delta():
    """A primary mirror snapshot orphaned by a failed sync (it never
    reached the secondary) must NOT become the next delta base -- that
    would silently skip the writes it froze."""
    async def main():
        site_a, site_b = await two_clusters()
        mon_a, osds_a, ra, ia = site_a
        mon_b, osds_b, rb, ib = site_b
        rbd = RBD()
        try:
            await rbd.create(ia, "img", 2 * (1 << ORDER), order=ORDER)
            img = await Image.open(ia, "img")
            await img.write(0, b"first")
            await img.close()
            await mirror_sync(ia, ib, "img")          # .mirror.1 on both
            # delta write, then a "failed sync": the primary snap is
            # taken but the copy never happens
            img = await Image.open(ia, "img")
            await img.write(0, b"SECOND-GEN")
            await img.create_snap(".mirror.2")        # orphan
            await img.close()
            out = await mirror_sync(ia, ib, "img")
            assert out["snap"] == ".mirror.3"
            d = await Image.open(ib, "img", read_only=True)
            assert await d.read(0, 10) == b"SECOND-GEN"
            await d.close()
        finally:
            await teardown(mon_a, osds_a, ra)
            await teardown(mon_b, osds_b, rb)
    run(main())


def test_mirror_live_image_and_interrupted_copy_rollback():
    """An image held OPEN by a client must still replicate (snap-only
    handles skip the exclusive lock), and an interrupted copy (dst
    HEAD touched, never frozen) must roll back before the next delta."""
    async def main():
        site_a, site_b = await two_clusters()
        mon_a, osds_a, ra, ia = site_a
        mon_b, osds_b, rb, ib = site_b
        rbd = RBD()
        try:
            await rbd.create(ia, "live", 2 * (1 << ORDER), order=ORDER)
            holder = await Image.open(ia, "live")   # client holds lock
            await holder.write(0, b"gen1")
            out = await mirror_sync(ia, ib, "live")
            assert out["snap"] == ".mirror.1"       # no EBUSY
            # simulate a sync that died mid-copy: orphan primary snap
            # + half-applied delta on the secondary HEAD
            await holder.write(0, b"gen2")
            snapper = await Image.open(ia, "live", exclusive=False)
            await snapper.create_snap(".mirror.2")  # orphan
            await snapper.close()
            dirty = await Image.open(ib, "live")
            await dirty.write(0, b"HALF")           # never frozen
            await dirty.close()
            # primary reverts the content: base-diff would see "no
            # change" and freeze the stale HALF without the rollback
            await holder.write(0, b"gen1")
            out = await mirror_sync(ia, ib, "live")
            d = await Image.open(ib, "live", read_only=True)
            assert await d.read(0, 4) == b"gen1"
            await d.close()
            # a foreign snapshot sharing the prefix must not crash
            s2 = await Image.open(ia, "live", exclusive=False)
            await s2.create_snap(".mirror.pre-upgrade")
            await s2.close()
            await mirror_sync(ia, ib, "live")
            await holder.close()
        finally:
            await teardown(mon_a, osds_a, ra)
            await teardown(mon_b, osds_b, rb)
    run(main())


def test_scrub_reserver_lease_expires():
    from ceph_tpu_torch.common.reserver import AsyncReserver
    import time

    r = AsyncReserver(1)
    assert r.get_or_fail("pgA", lease=0.05)
    assert not r.get_or_fail("pgB", lease=0.05)   # slot busy
    time.sleep(0.06)
    # the crashed holder's lease lapsed: the slot frees itself
    assert r.get_or_fail("pgB", lease=0.05)
    r.release("pgB")


def test_mirror_daemon_replays_enabled_images():
    async def main():
        site_a, site_b = await two_clusters()
        mon_a, osds_a, ra, ia = site_a
        mon_b, osds_b, rb, ib = site_b
        rbd = RBD()
        try:
            for name in ("img1", "img2", "img3"):
                await rbd.create(ia, name, 1 << ORDER, order=ORDER)
                img = await Image.open(ia, name)
                await img.write(0, f"content-{name}".encode())
                await img.close()
            await mirror_enable(ia, "img1")
            await mirror_enable(ia, "img2")   # img3 NOT mirrored
            daemon = MirrorDaemon(ia, ib, interval=0.5)
            await daemon.sync_all()
            assert sorted(await rbd.list(ib)) == ["img1", "img2"]
            for name in ("img1", "img2"):
                d = await Image.open(ib, name, read_only=True)
                want = f"content-{name}".encode()
                assert await d.read(0, len(want)) == want
                await d.close()
            # daemon loop picks up new writes
            daemon.start()
            img = await Image.open(ia, "img1")
            await img.write(0, b"updated-img1!")
            await img.close()
            for _ in range(40):
                await asyncio.sleep(0.25)
                d = await Image.open(ib, "img1", read_only=True)
                got = await d.read(0, 13)
                await d.close()
                if got == b"updated-img1!":
                    break
            assert got == b"updated-img1!"
            await daemon.stop()
            await mirror_disable(ia, "img2")
            assert (await daemon.sync_all())["img1"]["snap"]
        finally:
            await teardown(mon_a, osds_a, ra)
            await teardown(mon_b, osds_b, rb)
    run(main())
