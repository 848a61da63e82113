"""MDS + CephFS: namespace ops, striped file I/O, rename semantics,
journal replay on MDS failover (src/mds/Server.cc, MDLog, Journaler).

The port's counterpart of ``tests/test_cephfs.py``: its cases on
``ceph_tpu_torch``, the daemons and clients on ``device="cpu"``.
"""

import asyncio

import pytest

from ceph_tpu_torch.mds import FsError
from torch_app_cases import MDS, CephFS, Rados, make_cluster, run, teardown


async def boot(n_mds=1):
    mon, osds = await make_cluster(3)
    rados = await Rados(mon.msgr.addr).connect()
    for p in ("cephfs_metadata", "cephfs_data"):
        await rados.pool_create(p, pg_num=4)
    mdss = []
    for i in range(n_mds):
        m = MDS(name=chr(ord("a") + i))
        await m.start(mon.msgr.addr, create_pools=False)
        mdss.append(m)
    # wait for an active
    for _ in range(100):
        if any(m.state == "active" for m in mdss):
            break
        await asyncio.sleep(0.1)
    fs = await CephFS(mon.msgr.addr).mount()
    return mon, osds, rados, mdss, fs


async def shutdown(mon, osds, rados, mdss, fs):
    await fs.unmount()
    for m in mdss:
        await m.stop()
    await teardown(mon, osds, rados)


def test_namespace_and_file_io():
    async def main():
        mon, osds, rados, mdss, fs = await boot()
        try:
            await fs.mkdir("/docs")
            await fs.mkdir("/docs/sub")
            with pytest.raises(FsError):
                await fs.mkdir("/docs")            # EEXIST
            with pytest.raises(FsError):
                await fs.mkdir("/nope/child")      # ENOENT parent
            await fs.write_file("/docs/a.txt", b"hello fs")
            assert await fs.read_file("/docs/a.txt") == b"hello fs"
            st = await fs.stat("/docs/a.txt")
            assert st["type"] == "file" and st["size"] == 8
            assert await fs.ls("/") == ["docs"]
            assert await fs.ls("/docs") == ["a.txt", "sub"]
            # big striped file (crosses object boundaries)
            blob = bytes(range(256)) * 40000        # ~10 MB
            f = await fs.open("/docs/big", "w")
            await f.write(blob, 0)
            await f.close()
            assert (await fs.stat("/docs/big"))["size"] == len(blob)
            f = await fs.open("/docs/big")
            assert await f.read(1000, len(blob) - 1000) == blob[-1000:]
            assert await f.read() == blob
            await f.close()
            # unlink purges data objects from the data pool
            dio = await rados.open_ioctx("cephfs_data")
            n_before = len(await dio.list_objects())
            await fs.unlink("/docs/big")
            n_after = len(await dio.list_objects())
            assert n_after < n_before
            assert not await fs.exists("/docs/big")
            # rmdir refuses non-empty
            with pytest.raises(FsError):
                await fs.rmdir("/docs")
            await fs.rmdir("/docs/sub")
            # truncate
            f = await fs.open("/docs/a.txt", "r+")
            await f.truncate(5)
            await f.close()
            assert await fs.read_file("/docs/a.txt") == b"hello"
        finally:
            await shutdown(mon, osds, rados, mdss, fs)
    run(main())


def test_rename_semantics():
    async def main():
        mon, osds, rados, mdss, fs = await boot()
        try:
            await fs.mkdir("/a")
            await fs.mkdir("/b")
            await fs.write_file("/a/f", b"payload")
            await fs.rename("/a/f", "/b/g")
            assert not await fs.exists("/a/f")
            assert await fs.read_file("/b/g") == b"payload"
            # rename over an existing file replaces it (and purges it)
            await fs.write_file("/b/old", b"stale")
            await fs.rename("/b/g", "/b/old")
            assert await fs.read_file("/b/old") == b"payload"
            # rename onto itself is a POSIX no-op -- it must NOT purge
            # the file's own data as a "replaced target"
            await fs.rename("/b/old", "/b/old")
            assert await fs.read_file("/b/old") == b"payload"
            # open flags: 'w+' truncates, 'a' appends at EOF
            f = await fs.open("/b/old", "a")
            await f.write(b"-more")
            await f.close()
            assert await fs.read_file("/b/old") == b"payload-more"
            f = await fs.open("/b/old", "w+")
            await f.write(b"fresh")
            await f.close()
            assert await fs.read_file("/b/old") == b"fresh"
            # dir rename carries the subtree
            await fs.write_file("/a/deep", b"x")
            await fs.rename("/a", "/c")
            assert await fs.read_file("/c/deep") == b"x"
            assert not await fs.exists("/a")
            # rename dir over non-empty dir refused
            await fs.mkdir("/d")
            await fs.write_file("/d/busy", b"y")
            with pytest.raises(FsError):
                await fs.rename("/c", "/d")
            # a directory must not move into its own subtree
            await fs.mkdir("/c/inner")
            with pytest.raises(FsError) as ei:
                await fs.rename("/c", "/c/inner/c")
            assert "EINVAL" in str(ei.value)
            assert await fs.read_file("/c/deep") == b"x"
            # a file must not replace a directory (even an empty one)
            await fs.mkdir("/emptydir")
            with pytest.raises(FsError) as ei:
                await fs.rename("/b/old", "/emptydir")
            assert "EISDIR" in str(ei.value)
            # dir over empty dir IS allowed and reclaims the dirfrag
            await fs.rename("/c/inner", "/emptydir")
            assert await fs.exists("/emptydir")
        finally:
            await shutdown(mon, osds, rados, mdss, fs)
    run(main())


def test_mds_failover_journal_replay():
    async def main():
        mon, osds, rados, mdss, fs = await boot(n_mds=2)
        try:
            active = next(m for m in mdss if m.state == "active")
            standby = next(m for m in mdss if m is not active)
            await fs.mkdir("/pre")
            await fs.write_file("/pre/file", b"before failover")
            # kill the active MDS; the standby must win the lock,
            # replay the journal, and serve the same namespace
            await active.stop()
            for _ in range(200):
                if standby.state == "active":
                    break
                await asyncio.sleep(0.1)
            assert standby.state == "active", "standby never took over"
            assert await fs.read_file("/pre/file") == b"before failover"
            await fs.mkdir("/post")
            await fs.write_file("/post/new", b"after failover")
            assert await fs.ls("/") == ["post", "pre"]
        finally:
            await shutdown(mon, osds, rados, mdss, fs)
    run(main())


def test_lost_reply_resend_dedup():
    """A mutation whose reply was lost is resent with the same reqid;
    the MDS must acknowledge, not re-apply (no spurious EEXIST)."""
    async def main():
        mon, osds, rados, mdss, fs = await boot()
        try:
            m = mdss[0]
            out1 = await m._handle({"op": "mkdir", "path": "/once",
                                    "reqid": "client.x:1"})
            out2 = await m._handle({"op": "mkdir", "path": "/once",
                                    "reqid": "client.x:1"})   # resend
            assert out2["dentry"]["ino"] == out1["dentry"]["ino"]
            with pytest.raises(Exception):        # different reqid
                await m._handle({"op": "mkdir", "path": "/once",
                                 "reqid": "client.x:2"})
            # dedup survives failover via journal replay
            await m.stop()
            m2 = MDS(name="b")
            await m2.start(mon.msgr.addr, create_pools=False)
            mdss.append(m2)
            for _ in range(200):
                if m2.state == "active":
                    break
                await asyncio.sleep(0.1)
            out3 = await m2._handle({"op": "mkdir", "path": "/once",
                                     "reqid": "client.x:1"})
            assert out3["dentry"]["ino"] == out1["dentry"]["ino"]
        finally:
            await shutdown(mon, osds, rados, mdss, fs)
    run(main())


def test_journal_replay_after_crash_window():
    """Events journaled but not applied (crash between append and
    omap update) must be re-applied when the next MDS activates."""
    async def main():
        mon, osds, rados, mdss, fs = await boot()
        try:
            m = mdss[0]
            await fs.mkdir("/kept")
            # simulate the crash window: journal an event WITHOUT
            # applying it, then fail the MDS over
            ev = {"op": "link", "dir": 1, "name": "ghost",
                  "dentry": {"ino": 424242, "type": "dir",
                             "mode": 0o755}, "mkdir": True}
            await m.journal.append(ev)
            await m.stop()
            m2 = MDS(name="b")
            await m2.start(mon.msgr.addr, create_pools=False)
            mdss.append(m2)
            for _ in range(200):
                if m2.state == "active":
                    break
                await asyncio.sleep(0.1)
            # the replayed event materialized the dentry
            assert await fs.ls("/") == ["ghost", "kept"]
        finally:
            await shutdown(mon, osds, rados, mdss, fs)
    run(main())
