"""libradosstriper (per-op shared/exclusive locking) and
SimpleRADOSStriper (persistent exclusive lock, the libcephsqlite
backing contract).

The port's counterpart of ``tests/test_radosstriper.py``: its cases on
``ceph_tpu_torch``, the daemons and librados on ``device="cpu"``.
"""

import asyncio

import pytest

from ceph_tpu_torch.client.radosstriper import (RadosStriperCtx,
                                          SimpleRADOSStriper,
                                          StriperError)
from ceph_tpu_torch.client.striper import Layout
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
    r = Rados(addr, name="client.s")
    await r.connect()
    await r.mon_command("osd pool create",
                        {"name": "p", "pg_num": 4, "size": 2})
    io = await r.open_ioctx("p")
    return mon, osds, r, io


async def shutdown(mon, osds, *rs):
    for r in rs:
        await r.shutdown()
    for o in osds:
        await o.stop()
    await mon.stop()


def test_striper_ctx_multiclient_io_and_exclusive_remove():
    async def main():
        mon, osds, r, io = await boot()
        r2 = await Rados(mon.msgr.addr, name="client.s2").connect()
        io2 = await r2.open_ioctx("p")
        try:
            lay = Layout(stripe_unit=4096, stripe_count=2,
                         object_size=8192)
            a = RadosStriperCtx(io, lay)
            b = RadosStriperCtx(io2, lay)
            # concurrent writers from two clients (disjoint ranges)
            await asyncio.gather(
                a.write("big", b"A" * 20000, 0),
                b.write("big", b"B" * 20000, 20000))
            got = await a.read("big")
            assert got == b"A" * 20000 + b"B" * 20000
            assert (await b.stat("big"))["size"] == 40000
            # remove takes the EXCLUSIVE lock: a reader holding the
            # shared lock delays it, and after removal reads see gone
            await b.remove("big")
            assert (await a.stat("big"))["size"] == 0
        finally:
            await shutdown(mon, osds, r, r2)
    run(main())


def test_simple_striper_exclusive_open():
    async def main():
        mon, osds, r, io = await boot()
        r2 = await Rados(mon.msgr.addr, name="client.q2").connect()
        io2 = await r2.open_ioctx("p")
        try:
            f = await SimpleRADOSStriper(io, "db.sqlite").open()
            await f.write(b"sqlite page data " * 1000, 0)
            assert await f.size() == 17000
            # a second opener bounces while the lock is held
            with pytest.raises(StriperError, match="EBUSY"):
                await SimpleRADOSStriper(io2, "db.sqlite").open()
            await f.truncate(4096)
            assert await f.read() == (b"sqlite page data " * 1000)[:4096]
            await f.close()
            # released: the second client can now open and read
            g = await SimpleRADOSStriper(io2, "db.sqlite").open()
            assert await g.size() == 4096
            await g.close()
        finally:
            await shutdown(mon, osds, r, r2)
    run(main())


def test_concurrent_ops_one_handle_use_distinct_cookies():
    """Two concurrent ops on ONE handle must not release each other's
    lock (per-op cookies), and concurrent growers from two clients
    never lose a size update (atomic grow_size)."""
    async def main():
        mon, osds, r, io = await boot()
        r2 = await Rados(mon.msgr.addr, name="client.g2").connect()
        io2 = await r2.open_ioctx("p")
        try:
            lay = Layout(stripe_unit=4096, stripe_count=1,
                         object_size=8192)
            a = RadosStriperCtx(io, lay)
            b = RadosStriperCtx(io2, lay)
            # same handle, overlapping concurrent read+write
            await a.write("x", b"seed" * 1000, 0)
            out = await asyncio.gather(
                a.read("x", 4000, 0),
                a.write("x", b"tail" * 1000, 4000))
            assert out[0] == b"seed" * 1000
            # size race: both grow concurrently many times -- the max
            # must always win
            await asyncio.gather(*(
                c.write("race", b"z" * 100, i * 100)
                for i, c in enumerate([a, b] * 10)))
            assert (await a.stat("race"))["size"] == 20 * 100
            await a.remove("x")
            await a.remove("race")
        finally:
            await shutdown(mon, osds, r, r2)
    run(main())


def test_srs_recover_blocklists_previous_holder():
    """Recovering a SimpleRADOSStriper file from a lapsed holder must
    fence that holder at the OSDs before serving."""
    import json as _json

    async def main():
        mon, osds, r, io = await boot()
        r2 = await Rados(mon.msgr.addr, name="client.new").connect()
        io2 = await r2.open_ioctx("p")
        try:
            old = await SimpleRADOSStriper(io, "f").open()
            await old.write(b"mine", 0)
            # simulate lease lapse: force-break the lock (holder wedged)
            info = _json.loads(await io2.exec(
                old._first(), "lock", "get_info",
                _json.dumps({"name": "simplerados.lock"}).encode()))
            for lk in info["lockers"]:
                await io2.exec(old._first(), "lock", "break_lock",
                               _json.dumps({
                                   "name": "simplerados.lock",
                                   "locker": lk["entity"],
                                   "cookie": lk["cookie"]}).encode())
            new = await SimpleRADOSStriper(io2, "f").open()
            # the old holder's entity is blocklisted at the OSDs
            for _ in range(100):
                if all(o.osdmap.is_blocklisted("client.s")
                       for o in osds):
                    break
                await asyncio.sleep(0.05)
            assert all(o.osdmap.is_blocklisted("client.s")
                       for o in osds)
            # old handle's late write is refused at the data path
            with pytest.raises(Exception):
                await old.write(b"late dirty write", 100)
            await new.write(b"owned by new", 0)
            assert (await new.read(12, 0)) == b"owned by new"
            await new.close()
        finally:
            await shutdown(mon, osds, r, r2)
    run(main())
