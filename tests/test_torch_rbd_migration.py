"""rbd live migration: prepare/execute/commit with the destination
serving I/O throughout (src/librbd/migration role).

The port's counterpart of ``tests/test_rbd_migration.py``: its cases on
``ceph_tpu_torch``, the daemons and librados on ``device="cpu"``.
"""

import asyncio

import pytest

from ceph_tpu_torch.rbd import RBD, Image, RbdError
from ceph_tpu_torch.rbd.migration import (migration_abort, migration_commit,
                                    migration_execute,
                                    migration_prepare)
from torch_app_cases import OSD, Monitor, Rados, run


async def boot():
    mon = Monitor(rank=0, config={"mon_osd_min_down_reporters": 1})
    addr = await mon.start()
    mon.peer_addrs = [addr]
    osds = []
    for i in range(2):
        o = OSD(host=f"h{i}", whoami=i)
        await o.start(addr)
        osds.append(o)
    r = Rados(addr, name="client.mig")
    await r.connect()
    for pool in ("src", "dst"):
        await r.mon_command("osd pool create",
                            {"name": pool, "pg_num": 4, "size": 2})
    sio = await r.open_ioctx("src")
    dio = await r.open_ioctx("dst")
    return mon, osds, r, sio, dio


async def shutdown(mon, osds, r):
    await r.shutdown()
    for o in osds:
        await o.stop()
    await mon.stop()


def test_migration_full_cycle_with_live_io():
    async def main():
        mon, osds, r, sio, dio = await boot()
        try:
            await RBD().create(sio, "vm", size=8 << 20, order=20)
            img = await Image.open(sio, "vm")
            await img.write(0, b"block zero " * 1000)
            await img.write(3 << 20, b"deep data " * 1000)
            await img.close()

            await migration_prepare(sio, "vm", dio, "vm")
            # the SOURCE refuses writes now (read-only for clients)
            srcv = await Image.open(sio, "vm")
            assert srcv.read_only
            await srcv.close()

            # destination serves reads (fall-through) and writes
            # BEFORE any copy ran
            d = await Image.open(dio, "vm")
            assert (await d.read(0, 11)) == b"block zero "
            await d.write(100, b"LIVE-WRITE")       # copyup + write
            base = (b"block zero " * 1000)
            want = bytearray(base)
            want[100:110] = b"LIVE-WRITE"
            assert (await d.read(96, 18)) == bytes(want[96:114])
            await d.close()

            copied = await migration_execute(dio, "vm")
            assert copied > 0
            d = await Image.open(dio, "vm")
            assert (await d.read(3 << 20, 10)) == b"deep data "
            assert (await d.read(100, 10)) == b"LIVE-WRITE"
            await d.close()

            await migration_commit(dio, "vm")
            assert await RBD().list(sio) == []       # source gone
            d = await Image.open(dio, "vm")          # standalone now
            assert d._mig_marker is None
            assert (await d.read(3 << 20, 10)) == b"deep data "
            assert (await d.read(100, 10)) == b"LIVE-WRITE"
            await d.write(0, b"post-commit write")
            await d.close()
        finally:
            await shutdown(mon, osds, r)
    run(main())


def test_migration_abort_restores_source():
    async def main():
        mon, osds, r, sio, dio = await boot()
        try:
            await RBD().create(sio, "vm", size=4 << 20)
            img = await Image.open(sio, "vm")
            await img.write(0, b"keep me")
            await img.close()
            await migration_prepare(sio, "vm", dio, "vm")
            with pytest.raises(RbdError, match="EBUSY"):
                await migration_commit(dio, "vm")   # not executed yet
            await migration_abort(dio, "vm")
            assert await RBD().list(dio) == []
            img = await Image.open(sio, "vm")        # writable again
            assert not img.read_only
            assert (await img.read(0, 7)) == b"keep me"
            await img.write(0, b"still mine")
            await img.close()
            # double-prepare is refused while one is active
            await migration_prepare(sio, "vm", dio, "vm2")
            with pytest.raises(RbdError, match="EBUSY"):
                await migration_prepare(sio, "vm", dio, "vm3")
            await migration_abort(dio, "vm2")
        finally:
            await shutdown(mon, osds, r)
    run(main())


def test_migrating_destination_discard_and_guards():
    async def main():
        mon, osds, r, sio, dio = await boot()
        try:
            await RBD().create(sio, "vm", size=4 << 20, order=20)
            img = await Image.open(sio, "vm")
            await img.write(0, b"S" * (1 << 20))
            await img.close()
            await migration_prepare(sio, "vm", dio, "vm")
            d = await Image.open(dio, "vm")
            # discard of a fall-through range must yield ZEROS, never
            # resurrect source bytes (whole-object AND partial)
            await d.discard(0, 1 << 20)
            assert (await d.read(0, 64)) == b"\x00" * 64
            # snapshots are refused while migrating
            with pytest.raises(RbdError, match="EBUSY"):
                await d.create_snap("nope")
            await d.close()
            # neither end may be removed mid-migration
            with pytest.raises(RbdError, match="EBUSY"):
                await RBD().remove(sio, "vm")
            with pytest.raises(RbdError, match="EBUSY"):
                await RBD().remove(dio, "vm")
            await migration_abort(dio, "vm")
            assert await RBD().list(dio) == []
        finally:
            await shutdown(mon, osds, r)
    run(main())


def test_encrypted_image_migration_refused():
    async def main():
        mon, osds, r, sio, dio = await boot()
        try:
            await RBD().create(sio, "sec", size=1 << 20)
            img = await Image.open(sio, "sec")
            await img.encryption_format("pw")
            await img.close()
            with pytest.raises(RbdError, match="EOPNOTSUPP"):
                await migration_prepare(sio, "sec", dio, "sec")
        finally:
            await shutdown(mon, osds, r)
    run(main())
