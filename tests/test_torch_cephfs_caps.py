"""Mon-owned FSMap and the client capability/lease protocol: the
coherence layer the round-3 review flagged as missing (MDSMonitor.cc,
Locker.cc).  Two clients on one file must not clobber each other.

The port's counterpart of ``tests/test_cephfs_caps.py``: its cases on
``ceph_tpu_torch``, the daemons and clients on ``device="cpu"``.
"""

import asyncio

from test_torch_cephfs import boot, shutdown
from torch_app_cases import CephFS, run, wait_for


def test_fsmap_is_mon_owned():
    """The mon's FSMap names the active and the standbys; killing the
    active makes the MON promote (epoch bump), not a storage-lock
    race; clients re-resolve from the mon and keep working."""
    async def main():
        mon, osds, rados, mdss, fs = await boot(n_mds=2)
        try:
            fsmap = await rados.mon_command("fs dump", {})
            assert fsmap["active"] is not None
            assert len(fsmap["standbys"]) == 1
            epoch0 = fsmap["epoch"]
            active_name = fsmap["active"]["name"]

            await fs.mkdir("/pre")
            victim = next(m for m in mdss if m.name == active_name)
            await victim.stop()
            mdss.remove(victim)

            async def promoted():
                fm = await rados.mon_command("fs dump", {})
                return (fm["active"] is not None
                        and fm["active"]["name"] != active_name)
            for _ in range(120):
                if await promoted():
                    break
                await asyncio.sleep(0.25)
            fm = await rados.mon_command("fs dump", {})
            assert fm["active"]["name"] == mdss[0].name
            assert fm["epoch"] > epoch0
            # the promoted standby serves; old namespace survives
            await wait_for(lambda: mdss[0].state == "active",
                           timeout=30, msg="standby activates")
            await fs.mkdir("/post")
            assert sorted(await fs.ls("/")) == ["post", "pre"]
        finally:
            await shutdown(mon, osds, rados, mdss, fs)
    run(main())


def test_concurrent_append_writers_are_coherent():
    """Two clients interleaving appends on ONE file: without cap
    revocation each buffers its own size and overwrites the other
    (this test fails on the pre-caps code); with the w-cap handoff
    every record survives."""
    async def main():
        mon, osds, rados, mdss, fs = await boot(n_mds=1)
        fs2 = await CephFS(mon.msgr.addr, name="client.second").mount()
        try:
            await fs.write_file("/shared.log", b"")
            f1 = await fs.open("/shared.log", "a")
            f2 = await fs2.open("/shared.log", "a")
            records = []
            for i in range(6):
                rec_a = f"A{i}:".encode() * 10
                rec_b = f"B{i}:".encode() * 10
                await f1.write(rec_a)
                await f2.write(rec_b)      # revokes f1's w cap
                records += [rec_a, rec_b]
            await f1.close()
            await f2.close()
            data = await fs.read_file("/shared.log")
            assert len(data) == sum(len(r) for r in records), \
                f"lost bytes: {len(data)} vs " \
                f"{sum(len(r) for r in records)}"
            for rec in records:
                assert rec in data, f"record {rec[:6]} clobbered"
        finally:
            await fs2.unmount()
            await shutdown(mon, osds, rados, mdss, fs)
    run(main())


def test_stale_size_flush_cannot_shrink_peer_write():
    """Client A holds a file open while client B rewrites it longer;
    A's close must not flush a STALE smaller size over B's (the
    revocation forces A's flush BEFORE B's cap is granted)."""
    async def main():
        mon, osds, rados, mdss, fs = await boot(n_mds=1)
        fs2 = await CephFS(mon.msgr.addr, name="client.b").mount()
        try:
            f1 = await fs.open("/f", "w")
            await f1.write(b"short", 0)
            # B's open revokes A's cap (A flushes size=5 now)
            await fs2.write_file("/f", b"a much longer content")
            await f1.close()               # must NOT shrink back to 5
            got = await fs2.read_file("/f")
            assert got == b"a much longer content", got
        finally:
            await fs2.unmount()
            await shutdown(mon, osds, rados, mdss, fs)
    run(main())


def test_dead_client_lease_expires():
    """A client that vanishes without releasing its w cap must not
    block another writer past the lease."""
    async def main():
        mon, osds, rados, mdss, fs = await boot(n_mds=1)
        fs2 = await CephFS(mon.msgr.addr, name="client.dead").mount()
        try:
            f2 = await fs2.open("/zombie", "w")
            await f2.write(b"x", 0)
            # vanish: no release, no renewal, no flush
            if fs2._renew_task:
                fs2._renew_task.cancel()
            await fs2.rados.shutdown()
            t0 = asyncio.get_event_loop().time()
            f1 = await fs.open("/zombie", "w")   # blocks <= lease
            await f1.write(b"recovered", 0)
            await f1.close()
            waited = asyncio.get_event_loop().time() - t0
            assert waited < 15.0, f"revocation hung {waited:.1f}s"
            assert (await fs.read_file("/zombie")) == b"recovered"
        finally:
            await shutdown(mon, osds, rados, mdss, fs)
    run(main())
