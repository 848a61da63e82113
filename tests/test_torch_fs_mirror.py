"""cephfs-mirror: directory-tree replication between two clusters
(src/tools/cephfs_mirror PeerReplayer semantics).

The port's counterpart of ``tests/test_fs_mirror.py``: its cases on
``ceph_tpu_torch``, the daemons and clients on ``device="cpu"``.
"""

import asyncio

import pytest

from torch_app_cases import Rados
from torch_app_cases import CephFS, MDS
from ceph_tpu_torch.mds.fs_mirror import (
    FsMirrorDaemon, fs_mirror_add, fs_mirror_dirs, fs_mirror_remove,
    fs_mirror_sync,
)

from torch_app_cases import make_cluster, teardown, run


async def fs_site():
    mon, osds = await make_cluster(3)
    rados = await Rados(mon.msgr.addr).connect()
    for p in ("cephfs_metadata", "cephfs_data"):
        await rados.pool_create(p, pg_num=4)
    mds = MDS(name="a")
    await mds.start(mon.msgr.addr, create_pools=False)
    for _ in range(100):
        if mds.state == "active":
            break
        await asyncio.sleep(0.1)
    fs = await CephFS(mon.msgr.addr).mount()
    return mon, osds, rados, mds, fs


async def shutdown_site(site):
    mon, osds, rados, mds, fs = site
    await fs.unmount()
    await mds.stop()
    await teardown(mon, osds, rados)


def test_fs_mirror_tree_sync_and_prune():
    async def main():
        a = await fs_site()
        b = await fs_site()
        fsa, fsb = a[4], b[4]
        try:
            await fsa.mkdir("/proj")
            await fsa.mkdir("/proj/src")
            await fsa.write_file("/proj/readme", b"top doc")
            await fsa.write_file("/proj/src/main.py", b"print('hi')")
            out = await fs_mirror_sync(fsa, fsb, "/proj")
            assert out["copied"] == 2
            assert await fsb.read_file("/proj/readme") == b"top doc"
            assert await fsb.read_file("/proj/src/main.py") \
                == b"print('hi')"
            # unchanged files are NOT recopied (mtime+size carry over)
            out = await fs_mirror_sync(fsa, fsb, "/proj")
            assert out["copied"] == 0
            # change + delete propagate
            await fsa.write_file("/proj/src/main.py", b"print('bye')")
            await fsa.unlink("/proj/readme")
            out = await fs_mirror_sync(fsa, fsb, "/proj")
            assert out["copied"] == 1 and out["removed"] == 1
            assert await fsb.read_file("/proj/src/main.py") \
                == b"print('bye')"
            assert not await fsb.exists("/proj/readme")
        finally:
            await shutdown_site(a)
            await shutdown_site(b)
    run(main())


def test_fs_mirror_daemon_configured_dirs():
    async def main():
        a = await fs_site()
        b = await fs_site()
        fsa, fsb = a[4], b[4]
        try:
            await fsa.mkdir("/shared")
            await fsa.mkdir("/private")
            await fsa.write_file("/shared/f", b"replicate me")
            await fsa.write_file("/private/g", b"keep local")
            await fs_mirror_add(fsa.meta, "/shared")
            assert await fs_mirror_dirs(fsa.meta) == ["/shared"]
            daemon = FsMirrorDaemon(fsa, fsb, interval=0.5)
            await daemon.sync_all()
            assert await fsb.read_file("/shared/f") == b"replicate me"
            assert not await fsb.exists("/private")
            # the loop picks up later writes
            daemon.start()
            await fsa.write_file("/shared/new", b"late arrival")
            # wait for CONTENT, not mere existence: a sync cycle can
            # catch the source between dentry creation and the size
            # flush; a later cycle completes the copy
            got = b""
            for _ in range(40):
                await asyncio.sleep(0.25)
                if await fsb.exists("/shared/new"):
                    got = await fsb.read_file("/shared/new")
                    if got:
                        break
            assert got == b"late arrival"
            await daemon.stop()
            await fs_mirror_remove(fsa.meta, "/shared")
            assert await fs_mirror_dirs(fsa.meta) == []
        finally:
            await shutdown_site(a)
            await shutdown_site(b)
    run(main())
