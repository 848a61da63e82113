"""CephFS snapshots: directory-subtree freeze through the cap protocol
down to OSD object snaps, with trim on removal.

Role analog: src/mds/SnapServer.h, doc/dev/cephfs-snapshots.rst
(mkdir .snap/<name>), pg_pool_t removed_snaps trim on rmsnap.

The port's counterpart of ``tests/test_cephfs_snaps.py``: its cases on
``ceph_tpu_torch``, the daemons and clients on ``device="cpu"``.
"""

import asyncio

import pytest

from ceph_tpu_torch.mds.client import FsError
from torch_app_cases import MDS, OSD, CephFS, Monitor, Rados


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


async def boot():
    mon = Monitor(rank=0, config={"mon_osd_min_down_reporters": 1})
    addr = await mon.start()
    mon.peer_addrs = [addr]
    osds = []
    for i in range(2):
        o = OSD(host=f"h{i}", whoami=i)
        await o.start(addr)
        osds.append(o)
    mds = MDS(name="a")
    await mds.start(addr)
    for _ in range(200):
        if mds.state == "active":
            break
        await asyncio.sleep(0.1)
    fs = CephFS(addr, name="client.snap")
    await fs.mount()
    return mon, addr, osds, mds, fs


async def shutdown(mon, osds, mds, *fss):
    for f in fss:
        await f.unmount()
    await mds.stop()
    for o in osds:
        await o.stop()
    await mon.stop()


def test_snapshot_freezes_then_mutates_both_views_readable():
    """The VERDICT's 'Done =': snapshot a dir, mutate, read back both
    views."""
    async def main():
        mon, addr, osds, mds, fs = await boot()
        try:
            await fs.mkdir("/proj")
            await fs.write_file("/proj/report", b"v1 of the report")
            await fs.write_file("/proj/data", b"numbers " * 100)
            sid = await fs.mksnap("/proj", "s1")
            assert sid > 0
            # mutate after the snap: overwrite, extend, create, delete
            await fs.write_file("/proj/report", b"v2 REWRITTEN")
            await fs.write_file("/proj/new-file", b"post-snap file")
            await fs.unlink("/proj/data")
            # head view
            assert await fs.read_file("/proj/report") == b"v2 REWRITTEN"
            assert await fs.read_file("/proj/new-file") == \
                b"post-snap file"
            assert not await fs.exists("/proj/data")
            # frozen view: pre-snap bytes and namespace
            assert await fs.read_file("/proj/.snap/s1/report") == \
                b"v1 of the report"
            assert await fs.read_file("/proj/.snap/s1/data") == \
                b"numbers " * 100
            assert sorted(await fs.ls("/proj/.snap/s1")) == \
                ["data", "report"]
            assert sorted(await fs.ls("/proj/.snap")) == ["s1"]
            # snapshots are read-only
            with pytest.raises(FsError, match="EROFS"):
                f = await fs.open("/proj/.snap/s1/report", "r")
                await f.write(b"nope", 0)
        finally:
            await shutdown(mon, osds, mds, fs)
    run(main())


def test_snapshot_nested_dirs_and_second_snap():
    async def main():
        mon, addr, osds, mds, fs = await boot()
        try:
            await fs.mkdir("/d")
            await fs.mkdir("/d/sub")
            await fs.write_file("/d/sub/inner", b"deep content")
            await fs.mksnap("/d", "a")
            await fs.write_file("/d/sub/inner", b"changed")
            await fs.mksnap("/d", "b")
            await fs.write_file("/d/sub/inner", b"final")
            assert await fs.read_file("/d/.snap/a/sub/inner") == \
                b"deep content"
            assert await fs.read_file("/d/.snap/b/sub/inner") == \
                b"changed"
            assert await fs.read_file("/d/sub/inner") == b"final"
            assert sorted(await fs.lssnap("/d")) == ["a", "b"]
        finally:
            await shutdown(mon, osds, mds, fs)
    run(main())


def test_snapshot_captures_unflushed_writer_via_cap_revoke():
    """A client holding a write cap with buffered state at snap time:
    mksnap revokes the cap, the holder flushes, and the snapshot
    contains the flushed bytes."""
    async def main():
        mon, addr, osds, mds, fs = await boot()
        writer = CephFS(addr, name="client.writer")
        await writer.mount()
        try:
            await fs.mkdir("/live")
            f = await writer.open("/live/log", "w")
            await f.write(b"buffered by the writer", 0)
            # snap from the OTHER client while the writer holds 'w'
            await fs.mksnap("/live", "mid")
            got = await fs.read_file("/live/.snap/mid/log")
            assert got == b"buffered by the writer"
            await f.close()
        finally:
            await shutdown(mon, osds, mds, fs, writer)
    run(main())


def test_rmsnap_releases_and_trims():
    async def main():
        mon, addr, osds, mds, fs = await boot()
        try:
            await fs.mkdir("/t")
            await fs.write_file("/t/f", b"x" * 4096)
            sid = await fs.mksnap("/t", "gone")
            await fs.write_file("/t/f", b"y" * 4096)   # forces COW
            assert await fs.read_file("/t/.snap/gone/f") == b"x" * 4096
            await fs.rmsnap("/t", "gone")
            assert await fs.lssnap("/t") == {}
            with pytest.raises(FsError, match="ENOENT"):
                await fs.read_file("/t/.snap/gone/f")
            # the pool-level snap id is marked removed at the mon
            pool = mon.osdmap.get_pool_by_name("cephfs_data")
            assert sid in pool.removed_snaps
        finally:
            await shutdown(mon, osds, mds, fs)
    run(main())


def test_presnap_write_handle_continues_without_corrupting_snapshot():
    """A handle opened BEFORE the snapshot keeps writing after its cap
    is revoked by mksnap: the re-acquired cap carries the realm snapc,
    so post-snap writes COW and the frozen view stays exact (review
    scenario: stale striper without snapc silently overwrote it)."""
    async def main():
        mon, addr, osds, mds, fs = await boot()
        writer = CephFS(addr, name="client.keeper")
        await writer.mount()
        try:
            await fs.mkdir("/w")
            f = await writer.open("/w/file", "w")
            await f.write(b"frozen content here", 0)
            await fs.mksnap("/w", "s")          # revokes writer's cap
            # the SAME handle keeps writing (reacquires cap + snapc)
            await f.write(b"POST-SNAP OVERWRITE", 0)
            await f.fsync()
            assert await fs.read_file("/w/.snap/s/file") == \
                b"frozen content here"
            assert await fs.read_file("/w/file") == \
                b"POST-SNAP OVERWRITE"
            await f.close()
            # unlink after snap: the frozen view must survive the purge
            await fs.unlink("/w/file")
            assert await fs.read_file("/w/.snap/s/file") == \
                b"frozen content here"
        finally:
            await shutdown(mon, osds, mds, fs, writer)
    run(main())
