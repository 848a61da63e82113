"""librbd analog: image lifecycle, striped I/O, snapshots, clones,
exclusive lock (src/librbd, cls_rbd, CopyupRequest semantics).

The port's counterpart of ``tests/test_rbd.py``: its cases on
``ceph_tpu_torch``, the daemons and librados on ``device="cpu"``.
"""

import asyncio

import pytest

from torch_app_cases import Rados
from ceph_tpu_torch.rbd import RBD, Image, RbdError

from torch_app_cases import make_cluster, run, teardown

ORDER = 14                      # 16 KiB objects: multi-object images


async def cluster_io(n=3):
    mon, osds = await make_cluster(n)
    rados = await Rados(mon.msgr.addr).connect()
    await rados.pool_create("rbd", pg_num=8)
    io = await rados.open_ioctx("rbd")
    return mon, osds, rados, io


def test_image_lifecycle_and_io():
    async def main():
        mon, osds, rados, io = await cluster_io()
        rbd = RBD()
        try:
            await rbd.create(io, "img", 5 * (1 << ORDER), order=ORDER)
            assert await rbd.list(io) == ["img"]
            img = await Image.open(io, "img")
            assert await img.size() == 5 * (1 << ORDER)
            # write spanning three objects
            off = (1 << ORDER) - 100
            payload = bytes(range(256)) * ((2 * (1 << ORDER)) // 256)
            await img.write(off, payload)
            assert await img.read(off, len(payload)) == payload
            # unwritten ranges read as zeros
            assert await img.read(0, 64) == b"\0" * 64
            # write past end rejected
            with pytest.raises(RbdError):
                await img.write(5 * (1 << ORDER) - 1, b"xx")
            # shrink drops tail objects, grow re-extends with zeros
            await img.resize(1 << ORDER)
            await img.resize(5 * (1 << ORDER))
            assert await img.read(1 << ORDER, 128) == b"\0" * 128
            head = await img.read(off, 100)
            assert head == payload[:100]
            # discard zeroes a range
            await img.write(0, b"A" * 4096)
            await img.discard(0, 4096)
            assert await img.read(0, 4096) == b"\0" * 4096
            await img.close()
            await rbd.remove(io, "img")
            assert await rbd.list(io) == []
        finally:
            await teardown(mon, osds, rados)
    run(main())


def test_snapshots_and_rollback():
    async def main():
        mon, osds, rados, io = await cluster_io()
        rbd = RBD()
        try:
            await rbd.create(io, "img", 2 * (1 << ORDER), order=ORDER)
            img = await Image.open(io, "img")
            await img.write(0, b"v1-data")
            await img.create_snap("s1")
            await img.write(0, b"v2-data")
            # read through the snap handle
            snap_img = await Image.open(io, "img", snapshot="s1")
            assert await snap_img.read(0, 7) == b"v1-data"
            await snap_img.close()
            assert await img.read(0, 7) == b"v2-data"
            # snapshot removal refuses while protected
            await img.protect_snap("s1")
            with pytest.raises(RbdError):
                await img.remove_snap("s1")
            await img.unprotect_snap("s1")
            # rollback restores snap content to head
            await img.rollback_snap("s1")
            assert await img.read(0, 7) == b"v1-data"
            await img.remove_snap("s1")
            assert img.list_snaps() == []
            # image with snaps refuses removal
            await img.create_snap("s2")
            await img.close()
            with pytest.raises(RbdError):
                await rbd.remove(io, "img")
        finally:
            await teardown(mon, osds, rados)
    run(main())


def test_clone_copyup_flatten():
    async def main():
        mon, osds, rados, io = await cluster_io()
        rbd = RBD()
        try:
            size = 3 * (1 << ORDER)
            await rbd.create(io, "parent", size, order=ORDER)
            pimg = await Image.open(io, "parent")
            await pimg.write(0, b"P" * 1000)
            await pimg.write(1 << ORDER, b"Q" * 1000)
            await pimg.create_snap("base")
            # clone requires protection
            with pytest.raises(RbdError):
                await rbd.clone(io, "parent", "base", io, "child")
            await pimg.protect_snap("base")
            await rbd.clone(io, "parent", "base", io, "child")
            # parent mutates AFTER the snap; child must not see it
            await pimg.write(0, b"X" * 1000)
            child = await Image.open(io, "child")
            assert await child.read(0, 1000) == b"P" * 1000
            assert await child.read(1 << ORDER, 1000) == b"Q" * 1000
            # child write triggers copyup: rest of the object keeps
            # parent content
            await child.write(10, b"mine")
            got = await child.read(0, 1000)
            assert got[:10] == b"P" * 10
            assert got[10:14] == b"mine"
            assert got[14:] == b"P" * 986
            # unprotect refused while the child exists
            with pytest.raises(RbdError):
                await pimg.unprotect_snap("base")
            # discard of a never-copied-up clone range must read back
            # ZEROS, not fall through to the parent's bytes
            await child.discard(2 * (1 << ORDER), 512)
            assert await child.read(2 * (1 << ORDER), 512) == b"\0" * 512
            # flatten severs the link; parent snap then removable
            await child.flatten()
            assert child.meta["parent"] is None
            assert await child.read(1 << ORDER, 1000) == b"Q" * 1000
            await pimg.unprotect_snap("base")
            await pimg.remove_snap("base")
            # child reads unaffected after parent snap is gone
            got = await child.read(0, 14)
            assert got == b"P" * 10 + b"mine"
            await child.close()
            await pimg.close()
        finally:
            await teardown(mon, osds, rados)
    run(main())


def test_two_images_shared_ioctx_snapc_isolated():
    """Opening a second image on the same caller ioctx must not
    clobber the first image's write snap context (each Image owns a
    private data ioctx)."""
    async def main():
        mon, osds, rados, io = await cluster_io()
        rbd = RBD()
        try:
            await rbd.create(io, "A", 1 << ORDER, order=ORDER)
            await rbd.create(io, "B", 1 << ORDER, order=ORDER)
            a = await Image.open(io, "A")
            await a.write(0, b"a-original")
            await a.create_snap("s")
            b = await Image.open(io, "B")     # fresh snapc (seq 0)
            await b.write(0, b"b-data")
            # A's write after B opened must still COW against A@s
            await a.write(0, b"a-modified")
            snap_a = await Image.open(io, "A", snapshot="s")
            assert await snap_a.read(0, 10) == b"a-original"
            assert await a.read(0, 10) == b"a-modified"
            await snap_a.close()
            await a.close()
            await b.close()
        finally:
            await teardown(mon, osds, rados)
    run(main())


def test_header_watch_refreshes_holder_snapc():
    """A snapshot created by ANOTHER handle (rbd-mirror's snap-only
    open) must refresh the lock holder's snap context via the header
    watch before the snap op completes -- otherwise the holder's next
    write skips COW and silently mutates the 'frozen' snapshot."""
    async def main():
        mon, osds, rados, io = await cluster_io()
        rbd = RBD()
        try:
            await rbd.create(io, "img", 1 << ORDER, order=ORDER)
            holder = await Image.open(io, "img")    # exclusive client
            await holder.write(0, b"frozen-gen")
            # an administrative snap-only handle snapshots the image
            admin = await Image.open(io, "img", exclusive=False)
            await admin.create_snap("pit")
            await admin.close()
            # the HOLDER writes next -- with a refreshed snapc this
            # COWs; with a stale one it would corrupt the snapshot
            await holder.write(0, b"newer-data")
            snap = await Image.open(io, "img", snapshot="pit")
            assert await snap.read(0, 10) == b"frozen-gen"
            await snap.close()
            assert await holder.read(0, 10) == b"newer-data"
            await holder.close()
        finally:
            await teardown(mon, osds, rados)
    run(main())


def test_exclusive_lock():
    async def main():
        mon, osds, rados, io = await cluster_io()
        r2 = await Rados(mon.msgr.addr, name="client.other").connect()
        io2 = await r2.open_ioctx("rbd")
        rbd = RBD()
        try:
            await rbd.create(io, "img", 1 << ORDER, order=ORDER)
            img = await Image.open(io, "img")
            # a second writer bounces; a reader does not
            with pytest.raises(RbdError) as ei:
                await Image.open(io2, "img")
            assert "EBUSY" in str(ei.value)
            ro = await Image.open(io2, "img", read_only=True)
            await ro.close()
            await img.close()
            # lock released on close: writer can open now
            img2 = await Image.open(io2, "img")
            await img2.close()
            # simulate a dead holder: open, drop renewal, break
            img3 = await Image.open(io, "img")
            await Image.break_lock(io2, "img")
            img4 = await Image.open(io2, "img")
            await img4.write(0, b"new-owner")
            # the deposed holder is fenced at the OSDs: its next write
            # bounces there and the new owner's bytes stay
            with pytest.raises(RbdError, match="EBLOCKLISTED"):
                await img3.write(0, b"stale-own")
            assert await img4.read(0, 9) == b"new-owner"
            await img4.close()
            await img3.close()
        finally:
            await teardown(mon, osds, rados)
            await r2.shutdown()
    run(main())
